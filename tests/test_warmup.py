"""Host-warmup + batched-chunk hybrid build, and --single-threaded CLI
paths through the native engine."""

import numpy as np
import pytest

from hnsw_itu import native
from hnsw_itu.models import Bruteforce, IndexOptions, NSWBuilder
from hnsw_itu.models.hnsw import HNSWBuilder

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _recall(r_ids, gt_ids):
    nq, k = np.asarray(gt_ids).shape
    hits = sum(
        len(set(np.asarray(r_ids[i]).tolist())
            & set(np.asarray(gt_ids[i]).tolist()))
        for i in range(nq)
    )
    return hits / (nq * k)


def test_warmup_then_batched_nsw():
    rng = np.random.default_rng(33)
    n, nq, k = 2000, 50, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    b = NSWBuilder(
        IndexOptions(ef_construction=64, connections=16, max_connections=32,
                     size=n, batch_size=128, host_warmup=500),
        metric="hamming",
    )
    b.extend_batched(pts)
    assert b.n == n
    nsw = b.build()
    r = nsw.knns(qs, k, ef=64)
    # uniform-random 1024-bit points are a pathological dataset (distance
    # concentration; recall here swings +-0.05 with the seed). The spill
    # pass trades ~0.05 on THIS data for +0.02 on clustered data (the
    # benchmark distribution) — see tests/test_spill.py for the clustered
    # floor; this floor only guards against gross breakage.
    assert _recall(r.ids, gt.ids) >= 0.55


def test_warmup_covers_everything_hnsw():
    rng = np.random.default_rng(1)
    n = 400
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    b = HNSWBuilder(
        IndexOptions(ef_construction=32, connections=8, max_connections=16,
                     size=n, host_warmup=10_000),
        metric="hamming",
    )
    b.extend_batched(pts)
    h = b.build()
    assert h.size() == n
    r = h.search(pts[7], 3, 16)
    assert int(np.asarray(r.ids)[0]) == 7
    # the warmup now builds the hierarchy natively: the entry point is a
    # top-level slot (the last point that raised the top, hnsw.rs:207-210)
    # whose down-chain lands on a valid base row
    assert 0 <= h.base_ep() < n
