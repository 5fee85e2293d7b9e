"""Native host runtime tests: distance golden, exact-build semantics,
host knns vs brute-force oracle."""

import numpy as np
import pytest

from hnsw_itu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def test_native_hamming_golden():
    # cli/src/sketch.rs:52-58 golden pair -> 5
    a64 = np.zeros(16, np.uint64)
    b64 = np.zeros(16, np.uint64)
    a64[0] = 0b1111
    a64[15] = 0b1001
    b64[15] = 0b1011
    from hnsw_itu.ops import sketches_from_u64

    a = sketches_from_u64(a64[None])[0]
    b = sketches_from_u64(b64[None])[0]
    assert native.hamming(a, b) == 5


def test_host_build_and_knns_integers():
    pts = np.arange(1, 20, dtype=np.int32)[:, None]
    n, W = len(pts), 8
    adj = np.full((n, W), -1, np.int32)
    deg = np.zeros(n, np.int32)
    native.host_build(pts, "l2int", adj, deg, 1, n, m=4, efc=8, ep=0)
    d, i = native.host_knns(pts, "l2int", adj, deg, n,
                            np.array([[5]], np.int32), k=4, ef=8, ep=0)
    vals = sorted(int(pts[j, 0]) for j in i[0])
    assert vals == [3, 4, 5, 6]


def test_host_build_recall_vs_bruteforce():
    # calibration dataset: the pure-numpy reference-semantics build scores
    # 0.734 here (see test_nsw.py); the native engine must match that level
    rng = np.random.default_rng(33)
    n, nq, k = 2000, 50, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    W = 32
    adj = np.full((n, W), -1, np.int32)
    deg = np.zeros(n, np.int32)
    native.host_build(pts, "hamming", adj, deg, 1, n, m=16, efc=64, ep=0)
    assert deg.max() <= W

    gd, gi = native.host_bruteforce(pts, "hamming", qs, k)
    d, i = native.host_knns(pts, "hamming", adj, deg, n, qs, k=k, ef=64, ep=0)
    hits = sum(len(set(i[j]) & set(gi[j])) for j in range(nq))
    recall = hits / (nq * k)
    # same calibration as the device builders: ~0.73 on uniform random data
    assert recall >= 0.65, recall


def test_host_bruteforce_exact():
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 2**32, size=(500, 32), dtype=np.uint32)
    qs = pts[:5]
    d, i = native.host_bruteforce(pts, "hamming", qs, 3)
    assert (i[:, 0] == np.arange(5)).all()
    assert (d[:, 0] == 0).all()
