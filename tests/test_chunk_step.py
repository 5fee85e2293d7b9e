"""chunk_step (one-dispatch build round) vs the windowed reference path."""

import jax.numpy as jnp
import numpy as np

from hnsw_itu.graph import make_graph
from hnsw_itu.models import _build
from hnsw_itu.models.base import IndexOptions


def _state(rng, n0, cap, w, words=32):
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    g = make_graph(cap, w)
    # seed a small random-but-duplicate-free graph over the first n0 rows
    adj = np.full((cap, w), -1, np.int32)
    deg = np.zeros((cap,), np.int32)
    for i in range(n0):
        d = int(rng.integers(2, w // 2))
        nbrs = rng.choice(n0, size=d, replace=False)
        adj[i, :d] = nbrs
        deg[i] = d
    return jnp.asarray(pts), g._replace(adj=jnp.asarray(adj),
                                        deg=jnp.asarray(deg))


def test_chunk_step_matches_windowed_path():
    rng = np.random.default_rng(0)
    cap, w, n0, c, S, m, efc = 512, 16, 200, 64, 32, 8, 24
    points, graph = _state(rng, n0, cap, w)
    node_map = jnp.arange(cap, dtype=jnp.int32)
    chunk = np.asarray(points[n0 : n0 + c])
    new_ids = (n0 + np.arange(c)).astype(np.int32)
    # chunk_step/apply_inserts donate their state buffers: keep host copies
    pts_np = np.asarray(points)
    adj_np, deg_np = np.asarray(graph.adj), np.asarray(graph.deg)

    # fused: one dispatch
    p1, g1, _, _, d1 = _build.chunk_step(
        points, node_map, graph, None, _build.make_spill(cap),
        jnp.asarray(chunk),
        jnp.asarray(new_ids), jnp.int32(n0), jnp.int32(0), jnp.int32(c),
        S=S, efc=efc, m=m, metric_name="hamming", expand=1,
        prune_budget=64, entry_sample=0, use_entry=False,
    )

    # reference: windowed search + apply (the unscanned per-window path)
    graph = graph._replace(adj=jnp.asarray(adj_np), deg=jnp.asarray(deg_np))
    points2 = _build.write_points(
        jnp.asarray(pts_np), jnp.asarray(chunk), jnp.int32(n0)
    )
    eps = jnp.zeros((c,), jnp.int32)
    sel_parts = []
    for s in range(0, c, S):
        sel, _ = _build.search_select_window(
            points2, node_map, graph.adj, jnp.asarray(chunk), eps,
            jnp.int32(s), jnp.int32(c), None,
            S=S, efc=efc, m=m, metric_name="hamming", expand=1,
        )
        sel_parts.append(sel)
    g2, _, _, d2 = _build.apply_inserts(
        points2, node_map, graph, jnp.asarray(new_ids),
        jnp.concatenate(sel_parts), None, _build.make_spill(cap),
        metric_name="hamming", prune_budget=64,
    )

    np.testing.assert_array_equal(np.asarray(p1), np.asarray(points2))
    np.testing.assert_array_equal(np.asarray(g1.adj), np.asarray(g2.adj))
    np.testing.assert_array_equal(np.asarray(g1.deg), np.asarray(g2.deg))
    assert int(d1) == int(d2)


def test_chunk_step_skips_padding_windows():
    """Bucket padding past n_valid must insert nothing."""
    rng = np.random.default_rng(1)
    cap, w, n0, S = 256, 16, 100, 32
    points, graph = _state(rng, n0, cap, w)
    node_map = jnp.arange(cap, dtype=jnp.int32)
    cpad, c = 64, 40  # last window fully invalid? no: windows of 32 -> 2nd window half-valid, bucket pad 64
    chunk = np.zeros((cpad, 32), np.uint32)
    chunk[:c] = np.asarray(points[n0 : n0 + c])
    new_ids = np.full((cpad,), -1, np.int32)
    new_ids[:c] = n0 + np.arange(c)

    _, g1, _, _, _ = _build.chunk_step(
        points, node_map, graph, None, _build.make_spill(cap),
        jnp.asarray(chunk),
        jnp.asarray(new_ids), jnp.int32(n0), jnp.int32(0), jnp.int32(c),
        S=S, efc=16, m=8, metric_name="hamming", expand=1,
        prune_budget=32, entry_sample=0, use_entry=False,
    )
    deg = np.asarray(g1.deg)
    # all real inserts linked, nothing past the valid rows
    assert (deg[n0 : n0 + c] > 0).all()
    assert (deg[n0 + c :] == 0).all()


def test_batch_size_pow2_rounding():
    o = IndexOptions(batch_size=100)
    assert o.batch_size == 128


def test_split_chunk_bit_identical(monkeypatch):
    """HNSW_SPLIT_CHUNK=1 (two dispatches: chunk_search +
    apply_inserts) must produce bit-identical graphs to the fused
    chunk_step — it exists only to halve the compile-helper's program
    size at the largest shapes (W=64 @ 10.12M)."""
    import numpy as np

    from hnsw_itu.models import IndexOptions
    from hnsw_itu.models.hnsw import HNSWBuilder
    from hnsw_itu.models.nsw import NSWBuilder

    rng = np.random.default_rng(17)
    pts = rng.integers(0, 2**32, size=(400, 32), dtype=np.uint32)
    opts = dict(host_warmup=0, ef_construction=24, connections=6,
                max_connections=12, size=400, batch_size=64, scan_group=1)
    for cls in (NSWBuilder, HNSWBuilder):
        monkeypatch.delenv("HNSW_SPLIT_CHUNK", raising=False)
        a = cls(IndexOptions(**opts), metric="hamming")
        a.extend_batched(pts)
        monkeypatch.setenv("HNSW_SPLIT_CHUNK", "1")
        b = cls(IndexOptions(**opts), metric="hamming")
        b.extend_batched(pts)
        ga = a.base if hasattr(a, "base") else a.graph
        gb = b.base if hasattr(b, "base") else b.graph
        np.testing.assert_array_equal(np.asarray(ga.adj), np.asarray(gb.adj))
        np.testing.assert_array_equal(np.asarray(ga.deg), np.asarray(gb.deg))
        np.testing.assert_array_equal(np.asarray(a.spill), np.asarray(b.spill))
