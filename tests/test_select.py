"""select_neighbors heuristic golden test (src/index/nsw.rs:387-412)."""

import jax.numpy as jnp
import numpy as np

from hnsw_itu.ops import L2INT, select_neighbors


def _run(numbers, q, m):
    pts = jnp.asarray(np.array(numbers, np.int32)[:, None])
    qv = jnp.asarray(np.array([q], np.int32))
    d = L2INT.one_to_many(qv, pts)
    pair = L2INT.pairwise(pts, pts)
    ids = jnp.arange(len(numbers), dtype=jnp.int32)
    valid = jnp.ones((len(numbers),), bool)
    sel_ids, sel_d, n = select_neighbors(d, ids, pair, valid, m)
    sel = np.asarray(sel_ids)[: int(n)]
    return [numbers[i] for i in sel]


def test_heuristic_golden():
    # query 10 over {1,5,6,7,16,18}, m=3 -> keeps exactly {7, 16}
    # (nsw.rs:387-412; squared L2 is monotone in |a-b| so the strict
    #  comparisons of the heuristic are unchanged)
    got = _run([1, 5, 6, 7, 16, 18], 10, 3)
    assert got == [7, 16]


def test_heuristic_m_cap():
    # m=1 keeps only the nearest
    got = _run([1, 5, 6, 7, 16, 18], 10, 1)
    assert got == [7]


def test_heuristic_diversity_on_line():
    # on a line, a candidate behind a kept one is always closer to it than
    # to the query -> only the two flanking points survive
    got = _run([0, 100, 200], 50, 3)
    assert sorted(got) == [0, 100]


def test_heuristic_invalid_masked():
    pts = jnp.asarray(np.array([5, 7, 0], np.int32)[:, None])
    q = jnp.asarray(np.array([6], np.int32))
    d = L2INT.one_to_many(q, pts)
    pair = L2INT.pairwise(pts, pts)
    valid = jnp.array([True, True, False])
    sel_ids, _, n = select_neighbors(
        d, jnp.arange(3, dtype=jnp.int32), pair, valid, 3
    )
    sel = set(np.asarray(sel_ids)[: int(n)].tolist())
    assert 2 not in sel and 0 in sel
