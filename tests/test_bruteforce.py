"""Bruteforce exact-scan tests (bruteforce.rs parity)."""

import numpy as np

from hnsw_itu.models import Bruteforce


def test_exact_hamming_vs_numpy():
    rng = np.random.default_rng(21)
    pts = rng.integers(0, 2**32, size=(1000, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(7, 32), dtype=np.uint32)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    bf.build()
    r = bf.knns(qs, 10)

    a_bits = np.unpackbits(pts.view(np.uint8), axis=-1)
    for qi, q in enumerate(qs):
        qb = np.unpackbits(q.view(np.uint8))
        d = (a_bits != qb).sum(axis=1)
        order = np.lexsort((np.arange(d.size), d))[:10]
        np.testing.assert_array_equal(np.asarray(r.ids[qi]), order)
        np.testing.assert_array_equal(np.asarray(r.dists[qi]), d[order])


def test_l2int_search():
    bf = Bruteforce("l2int")
    pts = np.arange(20, dtype=np.int32)[:, None]
    bf.extend(pts)
    bf.build()
    r = bf.search(np.array([5], np.int32), 4)
    assert sorted(np.asarray(r.ids).tolist()) == [3, 4, 5, 6]


def test_incremental_add():
    bf = Bruteforce("l2int")
    for v in [5, 1, 9, 3]:
        bf.add(np.array([v], np.int32))
    assert bf.size() == 4
    r = bf.build().search(np.array([4], np.int32), 2)
    assert sorted(np.asarray(r.ids).tolist()) == [0, 3]  # points 5 and 3


def test_k_larger_than_n_pads_inf():
    bf = Bruteforce("l2int")
    bf.extend(np.arange(3, dtype=np.int32)[:, None])
    r = bf.build().search(np.array([0], np.int32), 5)
    ids = np.asarray(r.ids)
    assert (ids[:3] < 3).all()
    assert (ids[3:] == np.iinfo(np.int32).max).all()
