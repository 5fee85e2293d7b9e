"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from hnsw_itu.models import Bruteforce, IndexOptions, _build
from hnsw_itu.models.nsw import NSWBuilder
from hnsw_itu.parallel import ShardedNSW, knns_query_sharded, make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests need the 8-device CPU mesh"
    return make_mesh(8)


def test_sharded_index_recall(mesh):
    rng = np.random.default_rng(42)
    n, nq, k = 1600, 20, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = pts[:nq] ^ np.uint32(7)  # near-duplicate queries

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    opts = IndexOptions(host_warmup=0, ef_construction=48, connections=12, max_connections=24,
                        size=n, batch_size=64)
    idx = ShardedNSW.build(pts, opts, metric="hamming", mesh=mesh)
    assert idx.size() == n
    r = idx.knns(qs, k, ef=64)

    # global ids must come back correctly: the perturbed query's true NN is
    # its source point, which lives in a known shard
    ids = np.asarray(r.ids)
    assert (ids[:, 0] == np.arange(nq)).all()

    hits = 0
    for i in range(nq):
        hits += len(set(ids[i].tolist())
                    & set(np.asarray(gt.ids[i]).tolist()))
    # sharded search does ef per shard -> recall should be high
    assert hits / (nq * k) >= 0.8


def test_sharded_merge_is_sorted(mesh):
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 2**32, size=(256, 32), dtype=np.uint32)
    idx = ShardedNSW.build(
        pts,
        IndexOptions(host_warmup=0, ef_construction=16, connections=8, max_connections=16,
                     size=256),
        metric="hamming",
        mesh=mesh,
    )
    r = idx.knns(pts[:4], 8, ef=16)
    d = np.asarray(r.dists)
    assert (np.diff(d, axis=1) >= 0).all()
    assert (d[:, 0] == 0).all()  # the point itself


def test_sharded_build_step_semantics(mesh):
    """One sharded_build_step: every shard appends its chunk, links it into
    the shard subgraph, and counts only valid rows."""
    import jax.numpy as jnp

    from hnsw_itu.parallel import shard_leading, sharded_build_step

    S, cap, W, c = 8, 64, 8, 6
    rng = np.random.default_rng(5)
    pts0 = rng.integers(0, 2**32, size=(S, cap, 32), dtype=np.uint32)
    points_s = shard_leading(mesh, jnp.asarray(pts0))
    adj_s = shard_leading(mesh, jnp.full((S, cap, W), -1, jnp.int32))
    deg_s = shard_leading(mesh, jnp.zeros((S, cap), jnp.int32))
    ep_s = shard_leading(mesh, jnp.zeros((S,), jnp.int32))
    n_s = shard_leading(mesh, jnp.ones((S,), jnp.int32))
    valid = np.ones((S, c), bool)
    valid[-1, -2:] = False  # ragged last shard

    spill_s = shard_leading(
        mesh, jnp.full((S, cap + 1, _build.SPILL_WIDTH), -1, jnp.int32))
    points_s, adj_s, deg_s, spill_s, n_s, drops_s = sharded_build_step(
        points_s, adj_s, deg_s, spill_s, ep_s, n_s,
        shard_leading(mesh, jnp.asarray(pts0[:, 1 : 1 + c])),
        shard_leading(mesh, jnp.asarray(valid)),
        efc=16, m=4, metric_name="hamming", expand=1, prune_budget=16,
        mesh=mesh,
    )
    # drop accounting lives on the mesh: one int32 counter per shard
    assert np.asarray(drops_s).shape == (S,)
    assert (np.asarray(drops_s) >= 0).all()
    n = np.asarray(n_s)
    assert n.tolist() == [1 + c] * (S - 1) + [1 + c - 2]
    adj = np.asarray(adj_s)
    deg = np.asarray(deg_s)
    for s in range(S):
        # every inserted node got linked (at least to the entry point)
        for v in range(1, n[s]):
            assert deg[s, v] >= 1
        # no edges point at never-inserted rows
        live = adj[s][adj[s] >= 0]
        assert (live < n[s]).all()
        # rows hold no duplicate neighbors (beam-kernel invariant)
        for v in range(n[s]):
            row = adj[s, v][: deg[s, v]]
            assert len(set(row.tolist())) == len(row)


def test_sharded_hnsw_recall(mesh):
    from hnsw_itu.parallel import ShardedHNSW

    rng = np.random.default_rng(11)
    n, nq, k = 1600, 24, 10
    centers = rng.integers(0, 2**32, size=(16, 32), dtype=np.uint32)
    pts = centers[rng.integers(0, 16, size=n)] ^ np.packbits(
        rng.random((n, 1024)) < 0.05, axis=-1).view(np.uint32)
    qs = pts[:nq] ^ np.uint32(3)

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    opts = IndexOptions(host_warmup=0, ef_construction=48, connections=12,
                        max_connections=24, size=n, batch_size=64,
                        entry_sample=0)
    idx = ShardedHNSW.build(pts, opts, metric="hamming", mesh=mesh)
    assert idx.query_entry_sample > 0  # sampled entry replaces the descent
    r = idx.knns(qs, k, ef=64)
    ids = np.asarray(r.ids)
    assert (ids[:, 0] == np.arange(nq)).all()
    hits = sum(
        len(set(ids[i].tolist()) & set(np.asarray(gt.ids[i]).tolist()))
        for i in range(nq)
    )
    assert hits / (nq * k) >= 0.8


def test_sharded_fused_query_path(mesh):
    """enable_inline materializes per-shard inline rows and knns routes
    through the inline beam under shard_map (the CUDA kernel's path on a
    GPU; the XLA inline loop here); results must stay correct vs the exact
    oracle and the gather path."""
    from hnsw_itu.parallel import ShardedHNSW

    rng = np.random.default_rng(21)
    n, nq, k = 1600, 24, 10
    centers = rng.integers(0, 2**32, size=(16, 32), dtype=np.uint32)
    pts = centers[rng.integers(0, 16, size=n)] ^ np.packbits(
        rng.random((n, 1024)) < 0.05, axis=-1).view(np.uint32)
    qs = pts[:nq] ^ np.uint32(3)

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    opts = IndexOptions(host_warmup=0, ef_construction=48, connections=12,
                        max_connections=24, size=n, batch_size=64,
                        entry_sample=0)
    idx = ShardedHNSW.build(pts, opts, metric="hamming", mesh=mesh)
    idx.enable_inline()
    assert idx.adj_pts_s is not None, "per-shard inline rows expected"
    assert idx._query_path(k, 48) == "inline"  # never the kernel on a CPU

    r = idx.knns(qs, k, ef=48)
    ids = np.asarray(r.ids)
    d = np.asarray(r.dists)
    assert ids.shape == (nq, k)
    assert (np.diff(d, axis=1) >= 0).all()  # merged ascending
    assert (ids[:, 0] == np.arange(nq)).all()  # true NN is the source point
    hits = sum(
        len(set(ids[i].tolist()) & set(np.asarray(gt.ids[i]).tolist()))
        for i in range(nq)
    )
    assert hits / (nq * k) >= 0.8

    # the gather path on the same sharded index agrees on the top hit
    idx.adj_pts_s = None
    r2 = idx.knns(qs, k, ef=48)
    assert (np.asarray(r2.ids)[:, 0] == ids[:, 0]).all()


def test_query_sharded_matches_single(mesh):
    rng = np.random.default_rng(9)
    n, nq = 500, 16
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8, max_connections=16,
                     size=n),
        metric="hamming",
    )
    b.extend_batched(pts)
    nsw = b.build()
    single = nsw.knns(qs, 5, 32)
    sharded = knns_query_sharded(nsw, qs, 5, 32, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(single.ids), np.asarray(sharded.ids))
    np.testing.assert_array_equal(np.asarray(single.dists), np.asarray(sharded.dists))


@pytest.mark.parametrize("entry_sample", [1024, 32])
def test_sharded_scanned_build_bitexact(mesh, entry_sample):
    """sharded_build_steps_scanned must evolve the exact same state as G
    per-chunk sharded_build_step dispatches (chunks slice device-side and
    the validity mask is computed in-kernel — both asserted here), with
    fixed shard entries (1024 > shard size) and with sampled construction
    entries (32)."""
    rng = np.random.default_rng(9)
    n = 8 * 768  # cap_s=768: ramp to pos 512, then 4 steady 64-chunks
    pts = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)

    states = []
    for g in (1, 2):
        opts = IndexOptions(host_warmup=0, ef_construction=16, connections=8,
                            max_connections=16, size=n, batch_size=64,
                            scan_group=g, entry_sample=entry_sample)
        idx = ShardedNSW.build(pts, opts, metric="hamming", mesh=mesh)
        states.append((np.asarray(idx.adj_s), np.asarray(idx.deg_s),
                       np.asarray(idx.ns)))
    (a1, d1, n1), (a2, d2, n2) = states
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(a1, a2)


def test_query_sharded_hnsw_matches_single(mesh):
    """HNSW across the query-sharded mesh: the
    hierarchy is replicated, queries split — per-query results must be
    bit-identical to the single-device knns (both the greedy-descent and
    the sampled-entry entry policies)."""
    from hnsw_itu.models.hnsw import HNSWBuilder

    rng = np.random.default_rng(11)
    n, nq = 600, 16
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=n),
        metric="hamming",
    )
    b.extend_batched(pts)
    hnsw = b.build()
    assert len(hnsw.levels) >= 1  # exercise a real descent

    for entry_sample in (0, 128):  # descent, then matmul sampled entry
        hnsw.query_entry_sample = entry_sample
        single = hnsw.knns(qs, 5, 32)
        sharded = knns_query_sharded(hnsw, qs, 5, 32, mesh=mesh)
        np.testing.assert_array_equal(
            np.asarray(single.ids), np.asarray(sharded.ids))
        np.testing.assert_array_equal(
            np.asarray(single.dists), np.asarray(sharded.dists))


def test_query_sharded_reordered_returns_original_ids(mesh):
    """A reordered (BFS-relabeled) index must return ORIGINAL dataset ids
    from the query-sharded path too — the same id_map remap single-device
    knns applies."""
    rng = np.random.default_rng(13)
    n, nq = 500, 16
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = pts[:nq] ^ np.uint32(3)  # near-duplicate queries
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=n),
        metric="hamming",
    )
    b.extend_batched(pts)
    nsw = b.build()
    nsw.adj_pts = None
    nsw.reorder()
    assert nsw.id_map is not None
    single = nsw.knns(qs, 5, 32)
    sharded = knns_query_sharded(nsw, qs, 5, 32, mesh=mesh)
    np.testing.assert_array_equal(
        np.asarray(single.ids), np.asarray(sharded.ids))
    np.testing.assert_array_equal(
        np.asarray(single.dists), np.asarray(sharded.dists))
    # near-duplicate queries resolve to their source points' ORIGINAL ids
    assert (np.asarray(sharded.ids)[:, 0] == np.arange(nq)).all()
