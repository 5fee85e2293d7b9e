"""Inline-neighbor (adj_pts) query mode must match the regular path."""

import numpy as np

from hnsw_itu.models import Bruteforce, IndexOptions, NSWBuilder
from hnsw_itu.models.hnsw import HNSWBuilder


def test_nsw_inline_matches_regular():
    rng = np.random.default_rng(5)
    n, nq = 800, 16
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=n),
        metric="hamming",
    )
    b.extend_batched(pts)
    nsw = b.build()
    nsw.query_dedup = "beam"
    r1 = nsw.knns(qs, 5, 32)
    nsw.enable_inline()
    r2 = nsw.knns(qs, 5, 32)
    np.testing.assert_array_equal(np.asarray(r1.ids), np.asarray(r2.ids))
    np.testing.assert_array_equal(np.asarray(r1.dists), np.asarray(r2.dists))


def test_hnsw_inline_matches_regular():
    rng = np.random.default_rng(6)
    n, nq = 800, 16
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = pts[:nq] ^ np.uint32(9)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=n, batch_size=64),
        metric="hamming",
    )
    b.extend_batched(pts)
    h = b.build()
    h.query_dedup = "beam"
    r1 = h.knns(qs, 5, 32)
    h.enable_inline()
    r2 = h.knns(qs, 5, 32)
    np.testing.assert_array_equal(np.asarray(r1.ids), np.asarray(r2.ids))
    assert (np.asarray(r2.ids)[:, 0] == np.arange(nq)).all()


def test_truncated_inline_build(monkeypatch):
    """Large-N regime: the inline build buffer stores truncated prefixes
    and construction searches run on estimates with an exact re-score
    before select (_build.search_select inline_words). Graph quality must
    stay close to the full-inline build."""
    from hnsw_itu.utils import recall_at_k

    rng = np.random.default_rng(8)
    n, nq, k = 1500, 64, 10
    centers = rng.integers(0, 2**32, size=(24, 32), dtype=np.uint32)

    def clustered(m):
        c = centers[rng.integers(0, 24, size=m)]
        f = np.packbits(rng.random((m, 1024)) < 0.06, axis=-1).view(np.uint32)
        return c ^ f

    pts, qs = clustered(n), clustered(nq)
    opts = dict(host_warmup=0, ef_construction=48, connections=12,
                max_connections=24, size=n, batch_size=128)

    # budget forces mw = floor(budget / (n*W*4)) = 4 of 32 words
    monkeypatch.setenv(
        "HNSW_INLINE_BUILD_BYTES", str(1500 * 24 * 4 * 4)
    )
    bt = NSWBuilder(IndexOptions(**opts), metric="hamming")
    bt.extend_batched(pts)
    assert bt.inline_words == 4
    assert bt.adj_pts is not None and bt.adj_pts.shape[1] == 24 * 4
    it = bt.build()

    monkeypatch.delenv("HNSW_INLINE_BUILD_BYTES")
    bf_ = NSWBuilder(IndexOptions(**opts), metric="hamming")
    bf_.extend_batched(pts)
    assert bf_.inline_words == 0
    if_ = bf_.build()

    gt = Bruteforce("hamming")
    gt.extend(pts)
    gt_ids = np.asarray(gt.build().knns(qs, k).ids)
    rt = recall_at_k(np.asarray(it.knns(qs, k, 64).ids), gt_ids, k)
    rf = recall_at_k(np.asarray(if_.knns(qs, k, 64).ids), gt_ids, k)
    assert rt >= rf - 0.05, (rt, rf)
    assert rt >= 0.85, rt
