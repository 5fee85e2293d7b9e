"""GraphArrays edge-mutation tests (SimpleGraph parity, simplegraph.rs:124-176)."""

import jax.numpy as jnp
import numpy as np

from hnsw_itu.graph import (
    append_reverse_edges,
    make_graph,
    prune_rows,
    set_rows,
)
from hnsw_itu.ops import L2INT


def test_set_rows():
    g = make_graph(8, 4)
    ids = jnp.array([2, 5], jnp.int32)
    rows = jnp.array([[1, 3, -1, -1], [0, 1, 2, -1]], jnp.int32)
    g = set_rows(g, ids, rows)
    np.testing.assert_array_equal(np.asarray(g.adj[2]), [1, 3, -1, -1])
    assert int(g.deg[2]) == 2 and int(g.deg[5]) == 3
    assert int(g.deg[0]) == 0


def test_append_reverse_edges_grouped():
    g = make_graph(8, 4)
    g = set_rows(g, jnp.array([1], jnp.int32), jnp.array([[0, -1, -1, -1]], jnp.int32))
    # three new points 5,6,7 all appending to target 1; one to target 2
    targets = jnp.array([1, 1, 1, 2], jnp.int32)
    sources = jnp.array([7, 5, 6, 5], jnp.int32)
    res = append_reverse_edges(g, targets, sources)
    g = res.graph
    assert int(g.deg[1]) == 4
    np.testing.assert_array_equal(np.asarray(g.adj[1]), [0, 5, 6, 7])
    assert int(g.deg[2]) == 1 and int(g.adj[2, 0]) == 5
    assert bool(np.asarray(res.written).all())
    assert int(res.incoming[1]) == 3


def test_append_overflow_dropped():
    g = make_graph(8, 2)
    targets = jnp.array([3, 3, 3], jnp.int32)
    sources = jnp.array([0, 1, 2], jnp.int32)
    res = append_reverse_edges(g, targets, sources)
    assert int(res.graph.deg[3]) == 2
    np.testing.assert_array_equal(np.asarray(res.graph.adj[3]), [0, 1])
    assert np.asarray(res.written).sum() == 2


def test_append_invalid_targets_ignored():
    g = make_graph(4, 2)
    res = append_reverse_edges(
        g, jnp.array([-1, 2], jnp.int32), jnp.array([0, 1], jnp.int32)
    )
    assert int(res.graph.deg[2]) == 1
    assert int(jnp.sum(res.graph.deg)) == 1


def test_prune_rows_diversity():
    # node 0 at coordinate 10 with neighbors {9, 11, 12, 1}: the heuristic
    # keeps 9 (closest), rejects 11 (closer to 9?? no: |11-9|=2 > |11-10|=1 is
    # false -> rejected), rejects 12 (|12-9|=3 > 2? yes -> kept), etc.
    pts = np.array([10, 1, 9, 11, 12], np.int32)[:, None]
    g = make_graph(5, 4)
    g = set_rows(g, jnp.array([0], jnp.int32), jnp.array([[2, 3, 4, 1]], jnp.int32))
    node_ids = jnp.array([0], jnp.int32)
    node_pts = jnp.asarray(pts[[0]])
    nbr_pts = jnp.asarray(pts[np.asarray(g.adj[0])])[None]
    g2 = prune_rows(g, node_ids, node_pts, nbr_pts, 4, L2INT)
    kept = set(np.asarray(g2.adj[0]).tolist()) - {-1}
    # d(q=10): 9->1, 11->1, 12->4, 1->81. order: (1,id2=9),(1,id3=11),(4,12),(81,1)
    # keep 9; 11: d(11,9)=4 > 1? yes -> keep; 12: d(12,9)=9>16? no... squared:
    # d(12,q)=4, d(12,9)=9 > 4 -> yes, d(12,11)=1 > 4 -> no -> reject.
    # 1: d(1,q)=81, d(1,9)=64 > 81? no -> reject.
    assert kept == {2, 3}
    assert int(g2.deg[0]) == 2


def test_prune_rows_skips_invalid():
    pts = jnp.asarray(np.arange(5, dtype=np.int32)[:, None])
    g = make_graph(5, 3)
    g = set_rows(g, jnp.array([1], jnp.int32), jnp.array([[0, 2, -1]], jnp.int32))
    before = np.asarray(g.adj)
    g2 = prune_rows(
        g,
        jnp.array([-1], jnp.int32),
        pts[jnp.array([0])],
        pts[jnp.zeros((1, 3), jnp.int32)],
        3,
        L2INT,
    )
    np.testing.assert_array_equal(np.asarray(g2.adj), before)
