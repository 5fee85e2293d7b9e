"""Host-engine HNSW hierarchy descent (--single-threaded query path)."""

import numpy as np
import pytest

from hnsw_itu import native
from hnsw_itu.models import IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder
from hnsw_itu.utils import recall_at_k


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native host engine unavailable"
)


def _clustered(rng, n, centers):
    c = centers[rng.integers(0, len(centers), size=n)]
    flips = np.packbits(rng.random((n, 1024)) < 0.06, axis=-1).view(np.uint32)
    return c ^ flips


def test_host_descent_matches_reference_semantics():
    """Per-level ef=1 descent + base beam on the host engine: the
    --single-threaded HNSW query path (cli.query_index) must search the
    hierarchy like HNSW::search (hnsw.rs:285-293), not just the base layer
    from a fixed entry."""
    rng = np.random.default_rng(7)
    centers = rng.integers(0, 2**32, size=(24, 32), dtype=np.uint32)
    pts = _clustered(rng, 3000, centers)
    qs = _clustered(rng, 64, centers)
    k = 10

    opts = IndexOptions(ef_construction=48, connections=12,
                        max_connections=24, size=3000, batch_size=128,
                        host_warmup=0)
    b = HNSWBuilder(opts, metric="hamming")
    b.extend_batched(pts)
    idx = b.build()
    assert idx.levels, "fixture must actually have a hierarchy"

    points_np = np.asarray(idx.points)

    def host_query(eps):
        return native.host_knns(
            points_np, "hamming",
            np.ascontiguousarray(np.asarray(idx.base.adj)),
            np.ascontiguousarray(np.asarray(idx.base.deg)),
            idx.n, qs, k, 64, threads=1, eps=eps,
        )

    # descent chain (what the CLI single-threaded path does)
    eps = np.full((qs.shape[0],), idx.ep, np.int32)
    for lv, n_l in zip(reversed(idx.levels), reversed(idx.level_ns)):
        node_ids = np.asarray(lv.node_ids)[:n_l]
        _, loc = native.host_knns(
            points_np[node_ids], "hamming",
            np.ascontiguousarray(np.asarray(lv.graph.adj)[:n_l]),
            np.ascontiguousarray(np.asarray(lv.graph.deg)[:n_l]),
            n_l, qs, 1, 1, threads=1, eps=eps,
        )
        down = np.asarray(lv.down)[:n_l]
        eps = down[np.clip(loc[:, 0], 0, n_l - 1)].astype(np.int32)

    d_hier, i_hier = host_query(eps)

    # oracle
    d_bf, i_bf = native.host_bruteforce(points_np[: idx.n], "hamming", qs, k)
    rec = recall_at_k(i_hier, i_bf, k)
    assert rec >= 0.9, rec

    # descent entry points must be query-adaptive, not one fixed node
    assert len(np.unique(eps)) > 1

    # and the hierarchy path agrees with the device search on most results
    idx.query_entry_sample = 0
    dev = idx.knns(qs, k, 64)
    rec_dev = recall_at_k(i_hier, np.asarray(dev.ids), k)
    assert rec_dev >= 0.85, rec_dev


def test_host_warmup_builds_hierarchy():
    """host_warmup = size (the --single-threaded build) must produce a real
    HNSW — per-point level draws, populated level graphs, top-level entry
    point (hnsw.rs:183-244) — not a flat base graph, and query recall must
    match the device-built hierarchy."""
    rng = np.random.default_rng(11)
    centers = rng.integers(0, 2**32, size=(24, 32), dtype=np.uint32)
    N, k = 2000, 10
    pts = _clustered(rng, N, centers)
    qs = _clustered(rng, 64, centers)

    opts = IndexOptions(ef_construction=48, connections=12,
                        max_connections=24, size=N, batch_size=128,
                        host_warmup=N)
    b = HNSWBuilder(opts, metric="hamming")
    b.extend_batched(pts)
    # the warmup alone must have formed levels (E[n1] = N/m ~ 166)
    assert b.level_ns and b.level_ns[0] > 50
    idx = b.build()
    assert idx.level_ns == b.level_ns
    # entry point is a top-level slot whose down-chain reaches the base
    assert 0 <= idx.ep < idx.level_ns[-1]
    base_ep = idx.base_ep()
    assert 0 <= base_ep < N
    # level node ids are valid base rows; down pointers index the level
    # below (or base)
    for li, (lv, nl) in enumerate(zip(idx.levels, idx.level_ns)):
        ids = np.asarray(lv.node_ids)[:nl]
        down = np.asarray(lv.down)[:nl]
        assert ((ids >= 0) & (ids < N)).all()
        below = N if li == 0 else idx.level_ns[li - 1]
        assert ((down >= 0) & (down < below)).all()
        deg = np.asarray(lv.graph.deg)[:nl]
        if nl > 1:
            assert deg.max() > 0  # layers are actually wired

    d_bf, i_bf = native.host_bruteforce(np.asarray(idx.points)[:N], "hamming",
                                        qs, k)
    r = idx.knns(qs, k, 64)
    rec_host = recall_at_k(np.asarray(r.ids), i_bf, k)

    opts_dev = IndexOptions(ef_construction=48, connections=12,
                            max_connections=24, size=N, batch_size=128,
                            host_warmup=0)
    bd = HNSWBuilder(opts_dev, metric="hamming")
    bd.extend_batched(pts)
    rd = bd.build().knns(qs, k, 64)
    rec_dev = recall_at_k(np.asarray(rd.ids), i_bf, k)
    assert rec_host >= rec_dev - 0.03, (rec_host, rec_dev)
    assert rec_host >= 0.9, rec_host


def test_cli_single_threaded_uses_descent(tmp_path):
    """End-to-end: the CLI --single-threaded HNSW query returns high-recall
    results through the hierarchy."""
    import h5py

    from hnsw_itu.cli import main
    from hnsw_itu.ops.metrics import sketches_to_u64

    rng = np.random.default_rng(3)
    centers = rng.integers(0, 2**32, size=(16, 32), dtype=np.uint32)
    pts = _clustered(rng, 1500, centers)
    qs = _clustered(rng, 40, centers)
    data, quer = tmp_path / "d.h5", tmp_path / "q.h5"
    with h5py.File(data, "w") as f:
        f.create_dataset("hamming", data=sketches_to_u64(pts))
    with h5py.File(quer, "w") as f:
        f.create_dataset("hamming", data=sketches_to_u64(qs))

    res = tmp_path / "r.h5"
    gt = tmp_path / "gt.h5"
    assert main(["-q", "query", "-d", str(data), "-Q", str(quer),
                 "-o", str(res), "-k", "10", "-e", "64", "-c", "48",
                 "-m", "12", "-M", "24", "-S", "--sort"]) == 0
    assert main(["-q", "ground-truth", "-d", str(data), "-Q", str(quer),
                 "-o", str(gt), "-k", "10"]) == 0
    from hnsw_itu.utils import recall_files

    assert recall_files(str(res), str(gt), 10) >= 0.9
