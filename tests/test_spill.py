"""Reverse-edge spill recovery (the batched analogue of nsw.rs:113-129).

A reverse edge whose target row is already full must still reach the
target's prune candidate set: if it wins on diversity it enters the row
(the reference's incoming edge always participates in the prune); only
edges spilled past ``spill_width`` or on rows the prune budget missed are
counted as drops.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_itu.graph import GraphArrays, append_reverse_edges
from hnsw_itu.models import _build
from hnsw_itu.models._build import make_spill


def _mk_points(n, words=4, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 2**32, size=(n, words), dtype=np.uint32))


def test_append_returns_overflow_pos():
    g = GraphArrays(
        adj=jnp.asarray([[1, 2, -1, -1], [-1] * 4], jnp.int32).repeat(1, 0),
        deg=jnp.asarray([2, 0], jnp.int32),
    )
    # three edges to node 0: two fit (cols 2,3), one overflows (pos 4)
    res = append_reverse_edges(
        g,
        jnp.asarray([0, 0, 0], jnp.int32),
        jnp.asarray([5, 6, 7], jnp.int32),
    )
    assert np.asarray(res.written).tolist() == [True, True, False]
    assert np.asarray(res.pos).tolist() == [2, 3, 4]


def test_spilled_edge_recovered_by_prune():
    # node 0 sits at the origin; its row is full of FAR points; the new
    # (spilled) incoming source is NEAR, so the diversity prune must adopt it
    words = 4
    cap, W = 8, 4
    pts = np.zeros((cap, words), np.uint32)
    for i, bits in [(1, 32 * 4), (2, 32 * 3), (3, 32 * 2), (4, 32)]:
        # far points: many high bits set, mutually distant enough
        pts[i, : bits // 32] = 0xFFFFFFFF
    pts[5, 0] = 1  # near point: hamming distance 1 from node 0
    pts = jnp.asarray(pts)

    adj = np.full((cap, W), -1, np.int32)
    adj[0] = [1, 2, 3, 4]  # full row
    g = GraphArrays(jnp.asarray(adj), jnp.asarray([W, 0, 0, 0, 0, 0, 0, 0],
                                                  jnp.int32))

    node_map = jnp.arange(cap, dtype=jnp.int32)
    # new point 5 selected target 0 (already full -> spill)
    g2, _, _, dropped = _build.apply_inserts(
        pts, node_map, g,
        jnp.asarray([5], jnp.int32),
        jnp.asarray([[0]], jnp.int32),
        None,
        make_spill(cap),
        metric_name="hamming",
        prune_budget=4,
    )
    row0 = np.asarray(g2.adj[0])
    assert 5 in row0.tolist(), f"spilled near edge not recovered: {row0}"
    assert int(dropped) == 0


def test_spill_disabled_counts_drop():
    words = 4
    cap, W = 8, 4
    pts = _mk_points(cap, words)
    adj = np.full((cap, W), -1, np.int32)
    adj[0] = [1, 2, 3, 4]
    g = GraphArrays(jnp.asarray(adj), jnp.asarray([W] + [0] * 7, jnp.int32))
    node_map = jnp.arange(cap, dtype=jnp.int32)
    _, _, _, dropped = _build.apply_inserts(
        pts, node_map, g,
        jnp.asarray([5], jnp.int32),
        jnp.asarray([[0]], jnp.int32),
        None,
        None,
        metric_name="hamming",
        prune_budget=4,
    )
    assert int(dropped) == 1


def test_spill_beyond_width_counted():
    words = 4
    cap, W = 16, 4
    pts = _mk_points(cap, words)
    adj = np.full((cap, W), -1, np.int32)
    adj[0] = [1, 2, 3, 4]
    g = GraphArrays(jnp.asarray(adj), jnp.asarray([W] + [0] * 15, jnp.int32))
    node_map = jnp.arange(cap, dtype=jnp.int32)
    # 3 sources spill onto node 0 with spill width 2: one is dropped
    _, _, _, dropped = _build.apply_inserts(
        pts, node_map, g,
        jnp.asarray([5, 6, 7], jnp.int32),
        jnp.asarray([[0], [0], [0]], jnp.int32),
        None,
        make_spill(cap, 2),
        metric_name="hamming",
        prune_budget=4,
    )
    assert int(dropped) == 1


def test_clustered_recall_with_spill():
    """Clustered sketches (the benchmark distribution): the spill pass must
    hold recall ABOVE the no-spill baseline (measured at 20k: 0.988 with
    vs 0.969 without)."""
    from hnsw_itu.models import Bruteforce, IndexOptions
    from hnsw_itu.models.nsw import NSWBuilder
    from hnsw_itu.utils import recall_at_k

    rng = np.random.default_rng(7)
    n, nq, k = 8000, 300, 10
    centers = rng.integers(0, 2**32, size=(64, 32), dtype=np.uint32)

    def make(m):
        flips = np.packbits(
            rng.random((m, 1024), dtype=np.float32) < 0.08, axis=-1
        ).view(np.uint32)
        return centers[rng.integers(0, 64, size=m)] ^ flips

    pts, qs = make(n), make(nq)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)
    b = NSWBuilder(
        IndexOptions(ef_construction=64, connections=16, max_connections=32,
                     size=n, batch_size=128, host_warmup=0),
        metric="hamming",
    )
    b.extend_batched(pts)
    r = b.build().knns(qs, k, ef=48)
    rec = recall_at_k(np.asarray(r.ids), np.asarray(gt.ids), k)
    assert rec >= 0.97, rec


def test_full_build_drop_rate_low():
    """End-to-end on a deliberately saturated config (W only 1.5x m, so
    most rows run full): the spill pass must keep unrecoverable drops to
    the spill-width bound (<1% here; the same build WITHOUT the spill pass
    measured 16.6%). The post-build drain must leave no residual."""
    import jax.numpy as jnp

    from hnsw_itu.models import IndexOptions
    from hnsw_itu.models.nsw import NSWBuilder

    n = 3000
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(ef_construction=32, connections=8, max_connections=12,
                     size=n, batch_size=64, host_warmup=0),
        metric="hamming",
    )
    b.extend_batched(pts)
    b.build()
    assert not bool(np.asarray(jnp.any(b.spill[:-1] >= 0))), "residual spill"
    appended = n * 8
    assert b.total_edge_drops() <= appended * 0.01, (
        b.total_edge_drops(), appended)
