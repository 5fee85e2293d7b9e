"""Sampled entry-point selection — the matmul approach phase.

The reference (and classic HNSW) finds a good entry for the base-layer
search by greedy ef=1 descent through the hierarchy (hnsw.rs:285-293) —
a pointer-chasing phase that maps poorly onto lockstep batched search.
The array-native alternative: compute exact distances from every query to a
strided sample of the dataset in ONE dense matmul block and enter the graph at
the per-query argmin. For a sample of S points the entry lands in the best
~1/S quantile of the dataset — the same "skip the approach" effect as the
hierarchy, but as a single matmul instead of dozens of dependent steps.

Both query (`query_entry="sample"`) and construction use it; the greedy
descent remains available for exact reference-semantics parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .metrics import Metric


def strided_sample_ids(n, sample_size: int) -> jax.Array:
    """sample_size evenly-strided ids over [0, n) (n may be traced)."""
    s = jnp.arange(sample_size, dtype=jnp.int32)
    return jnp.clip((s * n) // sample_size, 0, n - 1).astype(jnp.int32)


def sampled_entry(points, qs, n, *, sample_size: int, metric: Metric):
    """Per-query entry ids: argmin over a strided sample (one matmul block).

    Args:
      points: [cap, ...] point buffer.
      qs: [B, ...] queries.
      n: live point count (traced ok).
    Returns int32[B] entry ids.
    """
    ids = strided_sample_ids(n, sample_size)
    sample = points[ids]
    d = metric.pairwise_mxu(qs, sample)  # [B, S]
    best = jnp.argmin(d, axis=1)
    return ids[best]

