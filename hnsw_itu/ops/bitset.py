"""Visited-set primitives: packed bitmask over node ids.

The reference benchmarks BitSet (src/collections/bitset.rs) and
GenerationSet (src/collections/generationset.rs) but its live search path
uses ``HashSet::with_capacity(2048)`` (src/index/nsw.rs:143). On the device the
right structure is the bitmask done properly: one bit per node, uint32
words, fully vectorized test / set. (The reference BitSet's quirk of using
only 8 bits per word — bitset.rs:21-27 — is *not* reproduced.)

A "generation" reset (generationset.rs:39-53) is unnecessary here: each
batched query owns a fresh mask allocated inside the jitted search, and XLA
reuses the buffer across calls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WORD_BITS = 32


def n_words(capacity: int) -> int:
    return -(-capacity // WORD_BITS)


def make(capacity: int) -> jax.Array:
    return jnp.zeros((n_words(capacity),), dtype=jnp.uint32)


def contains(mask: jax.Array, ids: jax.Array) -> jax.Array:
    """bool[...] — test bits for (possibly invalid/negative) ids.
    Out-of-range ids are clamped; callers mask validity separately."""
    idx = jnp.clip(ids, 0, mask.shape[0] * WORD_BITS - 1)
    word = idx // WORD_BITS
    bit = (idx % WORD_BITS).astype(jnp.uint32)
    return ((mask[word] >> bit) & jnp.uint32(1)) == jnp.uint32(1)


def insert(mask: jax.Array, ids: jax.Array, valid: jax.Array) -> jax.Array:
    """Set bits for ids where ``valid``; ids selected by ``valid`` must be
    unique (then OR == ADD per word, which keeps the scatter a single pass)."""
    idx = jnp.clip(ids, 0, mask.shape[0] * WORD_BITS - 1)
    word = idx // WORD_BITS
    bit = (idx % WORD_BITS).astype(jnp.uint32)
    add = jnp.where(valid, jnp.uint32(1) << bit, jnp.uint32(0))
    return mask.at[word].add(add, mode="drop")


def count(mask: jax.Array) -> jax.Array:
    """Population count — BitSet::len parity (bitset.rs:30-34)."""
    return jnp.sum(jax.lax.population_count(mask).astype(jnp.int32))
