"""BFS locality reorder (ops/reorder.py): an isomorphic relabel — results
must be IDENTICAL to the unreordered index after the id_map is applied,
for both NSW and HNSW and for both entry policies."""

import numpy as np
import pytest

from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder
from hnsw_itu.models.nsw import NSWBuilder
from hnsw_itu.ops.reorder import bfs_order, full_permutation


def test_bfs_order_is_permutation_and_local():
    adj = np.array([
        [1, 2, -1], [0, 3, -1], [0, 4, -1], [1, -1, -1],
        [2, 5, -1], [4, -1, -1], [-1, -1, -1],  # 6 disconnected
    ], np.int32)
    order = bfs_order(adj, 7, start=0)
    assert sorted(order.tolist()) == list(range(7))
    assert order[0] == 0
    assert set(order[1:3].tolist()) == {1, 2}  # level 1
    assert order[-1] == 6  # unreachable appended last
    perm, inv = full_permutation(order, 9)
    assert (perm[inv] == np.arange(9)).all()
    assert perm[7] == 7 and perm[8] == 8  # dead tail in place


def _clustered(rng, n, nq):
    centers = rng.integers(0, 2**32, size=(max(8, n // 64), 32),
                           dtype=np.uint32)
    assign = rng.integers(0, centers.shape[0], size=n)
    flips = np.packbits(
        rng.random((n, 1024), dtype=np.float32) < 0.05, axis=-1
    ).view(np.uint32)
    pts = centers[assign] ^ flips
    qs = pts[rng.integers(0, n, size=nq)] ^ np.uint32(9)
    return pts, qs


@pytest.mark.parametrize("kind", ["nsw", "hnsw"])
def test_reorder_results_identical(kind):
    rng = np.random.default_rng(21)
    n, nq, k = 800, 24, 10
    pts, qs = _clustered(rng, n, nq)
    opts = IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                        max_connections=16, size=n, batch_size=64)
    cls = NSWBuilder if kind == "nsw" else HNSWBuilder
    b = cls(opts, metric="hamming")
    b.extend_batched(pts)
    idx = b.build()
    idx.adj_pts = None  # force the plain path (reorder requires no tables)
    if kind == "hnsw":
        idx.level_adj_pts = None

    for entry_sample in (0, 128):
        idx.query_entry_sample = entry_sample
        before = idx.knns(qs, k, 48)
        b2 = cls(opts, metric="hamming")
        b2.extend_batched(pts)
        idx2 = b2.build()
        idx2.adj_pts = None
        if kind == "hnsw":
            idx2.level_adj_pts = None
        idx2.query_entry_sample = entry_sample
        idx2.reorder()
        after = idx2.knns(qs, k, 48)
        if entry_sample == 0:
            # fixed entry point: the relabel is isomorphic and the entry
            # follows it, so distances are IDENTICAL. Ids match wherever
            # the distance is unique in its row — the packed (d, id) key
            # tie-break orders equal-distance candidates by the NEW ids,
            # so tie positions may legally swap.
            db = np.asarray(before.dists)
            np.testing.assert_array_equal(db, np.asarray(after.dists))
            untied = np.ones_like(db, bool)
            untied[:, 1:] &= db[:, 1:] != db[:, :-1]
            untied[:, :-1] &= db[:, :-1] != db[:, 1:]
            untied[:, -1] = False  # the k-th result can tie with the
            # (k+1)-th candidate OUTSIDE the row — invisible here
            np.testing.assert_array_equal(
                np.asarray(before.ids)[untied],
                np.asarray(after.ids)[untied])
        else:
            # strided entry sample is POSITION-dependent: after the
            # relabel different physical nodes are sampled, so a few
            # queries may legitimately converge elsewhere. Demand
            # overall quality parity, not bit-equality.
            db = np.asarray(before.dists).astype(np.int64)
            da = np.asarray(after.dists).astype(np.int64)
            rows_same = (db == da).all(axis=1)
            assert rows_same.mean() >= 0.85, (
                f"entry-sample reorder shifted {100*(1-rows_same.mean()):.0f}%"
                " of rows"
            )
            # aggregate distance mass within 1% — no quality regression
            assert abs(int(da.sum()) - int(db.sum())) <= max(
                32, 0.01 * db.sum()
            )


def test_reorder_recall_and_id_space():
    """Reordered ids must live in the ORIGINAL id space: wherever the
    search finds an exact match (dist 0), the returned id is the point's
    own original dataset id — and the result equals the unreordered
    search bit for bit (fixed entry)."""
    rng = np.random.default_rng(22)
    n = 600
    pts, _ = _clustered(rng, n, 1)

    def build():
        b = NSWBuilder(
            IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                         max_connections=16, size=n),
            metric="hamming",
        )
        b.extend_batched(pts)
        idx = b.build()
        idx.adj_pts = None
        idx.query_entry_sample = 0
        return idx

    plain = build()
    before = plain.knns(pts[:32], 1, 32)
    idx = build()
    idx.reorder()
    r = idx.knns(pts[:32], 1, 32)
    ids, dists = np.asarray(r.ids)[:, 0], np.asarray(r.dists)[:, 0]
    np.testing.assert_array_equal(np.asarray(before.ids), np.asarray(r.ids))
    np.testing.assert_array_equal(
        np.asarray(before.dists), np.asarray(r.dists))
    hit = dists == 0
    assert hit.mean() >= 0.9  # ef=32 finds nearly every self-match
    assert (ids[hit] == np.arange(32)[hit]).all()


def test_reorder_with_inline_rows_matches_plain():
    """adj_pts holds neighbor POINT data in adjacency-slot order, so
    reorder permutes it in place of rebuilding; results must equal the
    no-inline reorder bit for bit."""
    rng = np.random.default_rng(23)
    pts, qs = _clustered(rng, 300, 16)
    opts = IndexOptions(host_warmup=0, ef_construction=16, connections=4,
                        max_connections=8, size=300)

    def build():
        b = NSWBuilder(opts, metric="hamming")
        b.extend_batched(pts)
        return b.build()

    idx = build()
    if idx.adj_pts is None:
        idx.enable_inline()
    assert idx.adj_pts is not None
    idx.reorder()
    with_inline = idx.knns(qs, 5, 32)

    ref = build()
    ref.adj_pts = None
    ref.reorder()
    plain = ref.knns(qs, 5, 32)
    np.testing.assert_array_equal(
        np.asarray(with_inline.ids), np.asarray(plain.ids))
    np.testing.assert_array_equal(
        np.asarray(with_inline.dists), np.asarray(plain.dists))


def test_reorder_hnsw_no_levels_remaps_ep():
    """With an empty hierarchy ``ep`` IS a base id and must follow the
    relabel (it becomes BFS rank 0)."""
    rng = np.random.default_rng(25)
    pts, qs = _clustered(rng, 300, 8)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=16, connections=4,
                     max_connections=8, size=300),
        metric="hamming",
    )
    b.extend_batched(pts)
    idx = b.build()
    idx.adj_pts = None
    idx.level_adj_pts = None
    # strip the hierarchy: ep becomes a base id
    idx.ep = idx.base_ep()
    idx.levels, idx.level_ns = [], []
    idx.query_entry_sample = 0  # fixed-ep entry exercises the remap
    # pin plain id ties: this test checks the relabel's isomorphism
    # (bit-equal results), which auto tie-decorrelation legitimately
    # perturbs at equal-distance boundaries
    idx.query_tie = "id"
    before = idx.knns(qs, 5, 32)
    idx.reorder()
    assert idx.ep == 0  # BFS starts at the entry point
    after = idx.knns(qs, 5, 32)
    np.testing.assert_array_equal(
        np.asarray(before.dists), np.asarray(after.dists))
    np.testing.assert_array_equal(
        np.asarray(before.ids)[:, 0], np.asarray(after.ids)[:, 0])


def test_reorder_serialization_roundtrip(tmp_path):
    from hnsw_itu.utils.serialize import load_index, save_index

    rng = np.random.default_rng(24)
    pts, qs = _clustered(rng, 400, 8)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=400),
        metric="hamming",
    )
    b.extend_batched(pts)
    idx = b.build()
    idx.adj_pts = None
    idx.level_adj_pts = None
    idx.reorder()
    r1 = idx.knns(qs, 5, 32)
    p = tmp_path / "ridx"
    save_index(str(p), idx)
    idx2, _ = load_index(str(p))
    r2 = idx2.knns(qs, 5, 32)
    np.testing.assert_array_equal(np.asarray(r1.ids), np.asarray(r2.ids))
    np.testing.assert_array_equal(np.asarray(r1.dists), np.asarray(r2.dists))


@pytest.mark.parametrize("kind", ["nsw", "hnsw"])
def test_opts_reorder_build_path(kind):
    """IndexOptions(reorder=True): build() relabels before the query
    tables materialize (the CLI --reorder path) and RESYNCS the builder
    to the relabeled arrays (no dead pre-permute HBM pinned)."""
    rng = np.random.default_rng(31)
    pts, qs = _clustered(rng, 400, 8)
    opts = IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                        max_connections=16, size=400, reorder=True)
    cls = NSWBuilder if kind == "nsw" else HNSWBuilder
    b = cls(opts, metric="hamming")
    b.extend_batched(pts)
    idx = b.build()
    assert idx.id_map is not None
    # builder arrays are the index's relabeled arrays (resync frees the
    # pre-permute copies)
    assert b.points is idx.points
    graph = idx.base if kind == "hnsw" else idx.graph
    bgraph = b.base if kind == "hnsw" else b.graph
    assert bgraph.adj is graph.adj
    # results come back in ORIGINAL ids and match a manual reorder
    ref = cls(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=400),
        metric="hamming",
    )
    ref.extend_batched(pts)
    ridx = ref.build()
    ridx.adj_pts = None
    if kind == "hnsw":
        ridx.level_adj_pts = None
    ridx.reorder()
    idx.query_entry_sample = ridx.query_entry_sample = 0
    a = idx.knns(qs, 5, 32)
    r = ridx.knns(qs, 5, 32)
    np.testing.assert_array_equal(np.asarray(a.dists), np.asarray(r.dists))


def test_builder_sealed_after_reorder_build():
    """A reorder build seals the builder: extend/build afterwards would
    compose relabels and corrupt the id_map."""
    import pytest

    from hnsw_itu.models import IndexOptions
    from hnsw_itu.models.hnsw import HNSWBuilder
    from hnsw_itu.models.nsw import NSWBuilder

    rng = np.random.default_rng(7)
    pts = rng.integers(0, 2**32, size=(120, 32), dtype=np.uint32)
    for cls in (NSWBuilder, HNSWBuilder):
        opts = IndexOptions(size=256, max_connections=8, connections=4,
                            ef_construction=16, host_warmup=0, reorder=True)
        b = cls(opts, metric="hamming")
        b.extend_batched(pts)
        idx = b.build()
        assert idx.id_map is not None
        with pytest.raises(RuntimeError, match="sealed"):
            b.build()
        with pytest.raises(RuntimeError, match="sealed"):
            b.extend_batched(pts[:4])
        with pytest.raises(RuntimeError, match="sealed"):
            b.extend(pts[:1])
    # non-reorder builders stay extendable (the historical contract)
    opts = IndexOptions(size=256, max_connections=8, connections=4,
                        ef_construction=16, host_warmup=0)
    b = NSWBuilder(opts, metric="hamming")
    b.extend_batched(pts)
    b.build()
    b.extend_batched(pts[:4])
    b.build()
