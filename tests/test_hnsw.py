"""HNSW tests mirroring test_hnsw (hnsw.rs:309-332) + recall checks."""

import numpy as np

from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder


def test_hnsw_integers():
    # 0..19, connections=3, efc=4: 4-NN of 5 is {3..6} or {4..7}
    # (hnsw.rs:309-328 accepts either; approximation tolerated)
    pts = np.arange(20, dtype=np.int32)[:, None]
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=4, connections=3, size=len(pts)),
        metric="l2int",
    )
    b.extend(pts)
    h = b.build()
    r = h.search(np.array([5], np.int32), 4, 4)
    got = sorted(np.asarray(r.ids).tolist())
    assert got in ([3, 4, 5, 6], [4, 5, 6, 7]), got


def test_hnsw_completeness():
    # k=ef=size returns every element (hnsw.rs:330-331)
    pts = np.arange(20, dtype=np.int32)[:, None]
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=4, connections=3, size=len(pts)),
        metric="l2int",
    )
    b.extend(pts)
    h = b.build()
    r = h.search(np.array([0], np.int32), h.size(), h.size())
    assert sorted(np.asarray(r.ids).tolist()) == list(range(20))


def test_hnsw_has_levels():
    # with 512 points and m=4 the hierarchy should actually form
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 1000, size=(512, 2)).astype(np.int32)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=4, max_connections=8,
                     size=512, batch_size=64),
        metric="l2int",
    )
    b.extend_batched(pts)
    h = b.build()
    assert len(h.levels) >= 1
    assert h.level_ns[0] > 0


def test_hnsw_batched_recall():
    rng = np.random.default_rng(99)
    n, nq, k = 2000, 50, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=64, connections=16, max_connections=32,
                     size=n, batch_size=128),
        metric="hamming",
    )
    b.extend_batched(pts)
    h = b.build()

    def recall(r):
        hits = 0
        for i in range(nq):
            hits += len(set(np.asarray(r.ids[i]).tolist())
                        & set(np.asarray(gt.ids[i]).tolist()))
        return hits / (nq * k)

    # same calibration as test_nsw: reference semantics give ~0.73 at ef=64
    # on uniform random sketches
    # uniform-random sketches are pathological (distance concentration);
    # the spill pass (test_spill.py) trades ~0.05 here for +0.02 on
    # clustered data, which test_spill.py guards at 0.97. Gross floor only.
    assert recall(h.knns(qs, k, ef=64)) >= 0.55
    assert recall(h.knns(qs, k, ef=256)) >= 0.93


def test_hnsw_deterministic_levels():
    # seeded level RNG (hnsw.rs:24-30): same options -> same hierarchy
    pts = np.random.default_rng(1).integers(0, 100, (300, 2)).astype(np.int32)
    shapes = []
    for _ in range(2):
        b = HNSWBuilder(
            IndexOptions(host_warmup=0, ef_construction=8, connections=4, size=300),
            metric="l2int",
        )
        b.extend_batched(pts)
        shapes.append(tuple(b.level_ns))
    assert shapes[0] == shapes[1]
