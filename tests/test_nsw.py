"""NSW index tests — tolerance-style, mirroring test_nsw (nsw.rs:366-385),
plus recall-vs-bruteforce on synthetic sketches."""

import numpy as np
import pytest

from hnsw_itu.models import Bruteforce, IndexOptions, NSWBuilder


def test_nsw_integers():
    # integers 1..19, 4-NN of 5 must be {3,4,5,6} (nsw.rs:366-385)
    pts = np.arange(1, 20, dtype=np.int32)[:, None]
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=4, size=len(pts)), metric="l2int"
    )
    b.extend(pts)
    nsw = b.build()
    r = nsw.search(np.array([5], np.int32), 4, 4)
    vals = sorted(pts[i, 0] for i in np.asarray(r.ids))
    assert vals == [3, 4, 5, 6]


def test_nsw_completeness():
    # k=ef=size returns everything (connectivity check, hnsw.rs:330-331)
    pts = np.arange(1, 20, dtype=np.int32)[:, None]
    b = NSWBuilder(IndexOptions(host_warmup=0, ef_construction=8, size=len(pts)), metric="l2int")
    b.extend(pts)
    nsw = b.build()
    r = nsw.search(pts[0], nsw.size(), nsw.size())
    assert sorted(np.asarray(r.ids).tolist()) == list(range(19))


def test_nsw_batched_build_recall():
    rng = np.random.default_rng(33)
    n, nq, k = 2000, 50, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=64, connections=16, max_connections=32,
                     size=n, batch_size=128),
        metric="hamming",
    )
    b.extend_batched(pts)
    nsw = b.build()
    def recall(r):
        hits = 0
        for i in range(nq):
            hits += len(set(np.asarray(r.ids[i]).tolist())
                        & set(np.asarray(gt.ids[i]).tolist()))
        return hits / (nq * k)

    # Calibration: building this exact dataset with the reference's
    # sequential insert semantics (heap search, unbounded candidates,
    # heuristic prune) yields recall 0.734 at ef=64 — uniform random
    # 1024-bit data is the hardest case (all pairs nearly equidistant).
    # Our batched build must stay close at ef=64 and converge with ef.
    # uniform-random sketches are pathological (distance concentration);
    # the spill pass (test_spill.py) trades ~0.05 here for +0.02 on
    # clustered data, which test_spill.py guards at 0.97. Gross floor only.
    assert recall(nsw.knns(qs, k, ef=64)) >= 0.55
    assert recall(nsw.knns(qs, k, ef=256)) >= 0.93


def test_nsw_capacity_growth():
    """Adding past the preallocated size grows the arrays (Vec-growth
    parity, simplegraph.rs:82-87) instead of raising — the old guard is
    gone; deeper growth coverage lives in tests/test_growth.py."""
    b = NSWBuilder(IndexOptions(host_warmup=0, size=4), metric="l2int")
    b.extend(np.arange(4, dtype=np.int32)[:, None])
    b.add(np.array([9], np.int32))
    idx = b.build()
    assert idx.size() == 5
    r = idx.knns(np.array([[9]], np.int32), 1, 8)
    assert int(np.asarray(r.ids)[0, 0]) == 4
