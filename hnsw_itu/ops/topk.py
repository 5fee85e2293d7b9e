"""Top-k / ordering primitives.

Replaces the reference's heap machinery with fixed-shape sorted buffers:

* ``MinK`` streaming k-smallest (src/collections/mod.rs:52-79) becomes a
  two-key sort + slice / tile-merge.
* The ``Distance`` total order — distance first, key tie-break
  (src/index/mod.rs:90-96) — is preserved everywhere via two-key
  ``lax.sort`` so results are deterministic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inverse_permutation(order: jax.Array) -> jax.Array:
    """Inverse of a permutation vector via scatter — one store per element
    instead of the full second bitonic sort that ``argsort(order)`` costs
    (the batch-sort/unsort pattern pays this every query batch)."""
    return (
        jnp.zeros_like(order)
        .at[order]
        .set(jnp.arange(order.shape[0], dtype=order.dtype))
    )


def sort_by_dist(d: jax.Array, i: jax.Array, *extras: jax.Array):
    """Sort parallel arrays ascending by (distance, id). Returns the same
    tuple structure sorted along the last axis."""
    out = jax.lax.sort((d, i) + tuple(extras), num_keys=2)
    return out


def min_k(d: jax.Array, i: jax.Array, k: int):
    """k smallest (distance, id) pairs, ascending, ties by id.

    Equivalent of MinK::min_k (src/collections/mod.rs:53-76) except the
    output is sorted (the reference's heap output is unsorted; the CLI sorts
    on request, cli/src/main.rs:272-274).
    """
    if d.shape[-1] <= k:
        return sort_by_dist(d, i)
    sd, si = sort_by_dist(d, i)
    return sd[..., :k], si[..., :k]


def merge_min_k(d_a, i_a, d_b, i_b, k: int):
    """Merge two candidate lists and keep the k smallest by (dist, id).
    Used for tile-by-tile brute-force scans and shard top-k reduction."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    return min_k(d, i, k)
