"""MinK / bitset parity tests (src/collections/mod.rs:96-115, bitset.rs:51-71)."""

import jax.numpy as jnp
import numpy as np

from hnsw_itu.ops import bitset, merge_min_k, min_k, sort_by_dist


def test_min_k_with_duplicates():
    # src/collections/mod.rs:96-103
    v = np.array([0, 9, 1, 8, 2, 7, 3, 6, 4, 5, 5, 4, 6, 3, 7, 2, 8, 1, 9, 0])
    ids = np.arange(v.size)
    d, i = min_k(jnp.asarray(v), jnp.asarray(ids), 5)
    assert sorted(np.asarray(d).tolist()) == [0, 0, 1, 1, 2]


def test_min_k2():
    # src/collections/mod.rs:105-110
    v = np.array([0, 1, 4, 2, 5, 9, 10, 3, 6, 7, 8, 11, 12, 13, 14])
    d, i = min_k(jnp.asarray(v), jnp.arange(v.size), 5)
    np.testing.assert_array_equal(np.asarray(d), [0, 1, 2, 3, 4])


def test_tie_break_by_id():
    # Distance::cmp ties broken by key (src/index/mod.rs:90-96)
    d = jnp.array([5, 5, 5, 1], jnp.int32)
    i = jnp.array([30, 10, 20, 40], jnp.int32)
    sd, si = sort_by_dist(d, i)
    np.testing.assert_array_equal(np.asarray(si), [40, 10, 20, 30])


def test_merge_min_k():
    d1 = jnp.array([1, 4, 9], jnp.int32)
    i1 = jnp.array([0, 1, 2], jnp.int32)
    d2 = jnp.array([2, 3, 9], jnp.int32)
    i2 = jnp.array([5, 6, 1], jnp.int32)
    d, i = merge_min_k(d1, i1, d2, i2, 4)
    np.testing.assert_array_equal(np.asarray(d), [1, 2, 3, 4])
    np.testing.assert_array_equal(np.asarray(i), [0, 5, 6, 1])


def test_bitset_insert_contains_count():
    m = bitset.make(1000)
    ids = jnp.array([0, 31, 32, 999, 500], jnp.int32)
    m = bitset.insert(m, ids, jnp.ones((5,), bool))
    assert np.asarray(bitset.contains(m, ids)).all()
    assert not np.asarray(
        bitset.contains(m, jnp.array([1, 30, 33, 998], jnp.int32))
    ).any()
    assert int(bitset.count(m)) == 5


def test_bitset_masked_insert():
    m = bitset.make(64)
    ids = jnp.array([3, 7], jnp.int32)
    m = bitset.insert(m, ids, jnp.array([True, False]))
    assert bool(bitset.contains(m, jnp.array([3]))[0])
    assert not bool(bitset.contains(m, jnp.array([7]))[0])


def test_inverse_permutation():
    import numpy as np

    from hnsw_itu.ops.topk import inverse_permutation

    rng = np.random.default_rng(5)
    for n in (1, 7, 512):
        p = rng.permutation(n).astype(np.int32)
        inv = np.asarray(inverse_permutation(jnp.asarray(p)))
        assert (p[inv] == np.arange(n)).all()
        assert (inv[p] == np.arange(n)).all()
