"""Distance kernel golden tests.

Mirrors the reference's distance tests: the hand-built sketch pair with
Hamming distance 5 (cli/src/sketch.rs:48-59) and the SIMD-vs-scalar
cross-validation over random pairs (cli/benches/distance/bench.rs:120-131).
"""

import numpy as np
import pytest

from hnsw_itu.ops import (
    HAMMING,
    L2,
    L2INT,
    pack_bits_u32,
    sketches_from_u64,
    sketches_to_u64,
    unpack_bits_u32,
)


def _np_hamming(a, b):
    ax = np.unpackbits(a.view(np.uint8), axis=-1)
    bx = np.unpackbits(b.view(np.uint8), axis=-1)
    return (ax != bx).sum(axis=-1)


def test_sketch_golden():
    # cli/src/sketch.rs:52-58: a=[0b1111,0,...,0b1001], b=[0,...,0b1011] -> 5
    a64 = np.zeros((1, 16), np.uint64)
    b64 = np.zeros((1, 16), np.uint64)
    a64[0, 0] = 0b1111
    a64[0, 15] = 0b1001
    b64[0, 15] = 0b1011
    a = sketches_from_u64(a64)
    b = sketches_from_u64(b64)
    d = HAMMING.one_to_many(a[0], b)
    assert int(d[0]) == 5


def test_hamming_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(8, 32), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(100, 32), dtype=np.uint32)
    got = np.asarray(HAMMING.pairwise(a, b))
    want = np.array([[_np_hamming(x, y) for y in b] for x in a])
    np.testing.assert_array_equal(got, want)


def test_hamming_mxu_matches_vpu():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, size=(16, 32), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(64, 32), dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(HAMMING.pairwise_mxu(a, b)), np.asarray(HAMMING.pairwise(a, b))
    )


def test_one_to_many_consistent():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(32,), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(17, 32), dtype=np.uint32)
    got = np.asarray(HAMMING.one_to_many(a, b))
    want = np.asarray(HAMMING.pairwise(a[None], b))[0]
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, size=(5, 32), dtype=np.uint32)
    bits = unpack_bits_u32(x)
    assert bits.shape == (5, 1024)
    np.testing.assert_array_equal(np.asarray(pack_bits_u32(bits)), x)


def test_u64_roundtrip_preserves_distance():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 2**63, size=(6, 16), dtype=np.uint64)
    packed = sketches_from_u64(rows)
    back = sketches_to_u64(packed)
    np.testing.assert_array_equal(back, rows)
    # distance computed on u32 packing == popcount of u64 xor
    want = [
        [bin(int(x ^ y)).count("1") for x, y in zip(rows[i], rows[j])]
        for i in range(6)
        for j in range(6)
    ]
    want = np.array([sum(w) for w in want]).reshape(6, 6)
    got = np.asarray(HAMMING.pairwise(packed, packed))
    np.testing.assert_array_equal(got, want)


def test_l2int():
    a = np.array([[2, 4, 16]], np.int32)
    b = np.array([[3, 3, 10], [2, 4, 16]], np.int32)
    got = np.asarray(L2INT.pairwise(a, b))
    # (1 + 1 + 36) = 38 — integer squared L2 like examples/main.rs:7-11
    np.testing.assert_array_equal(got, [[38, 0]])


def test_l2_mxu_close():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(8, 64)).astype(np.float32)
    b = rng.normal(size=(32, 64)).astype(np.float32)
    got = np.asarray(L2.pairwise_mxu(a, b))
    want = np.asarray(L2.pairwise(a, b))
    # the norm-expansion identity trades a little precision for matmul speed
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-2)
