"""Padded-adjacency graph arrays + vectorized edge mutation.

The reference stores graphs as ``Vec<T> + Vec<HashSet<Idx>>``
(reference/src/collections/simplegraph.rs:10-14) and mutates them one
edge at a time. Array-native redesign: a graph is a pair of preallocated device
arrays

    adj: int32[capacity, width]   (entries < 0 mean "no edge")
    deg: int32[capacity]          (live neighbor count per node)

mutated functionally inside jitted build steps (XLA updates donated buffers
in place). Edges are directed rows; the reference's undirected add_edge
(simplegraph.rs:93-100) corresponds to one forward row write plus a batched
reverse append.

``append_reverse_edges`` implements the grouped scatter-append that replaces
the sequential ``graph.add_edge(e, point_idx)`` loop of ``insert_neighbors``
(src/index/nsw.rs:101-103), and ``prune_rows`` the degree-cap re-prune of
nsw.rs:105-130, batched over a fixed budget of overfull nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ops.select import select_neighbors


class GraphArrays(NamedTuple):
    adj: jax.Array  # int32[capacity, width]
    deg: jax.Array  # int32[capacity]

    @property
    def capacity(self) -> int:
        return self.adj.shape[0]

    @property
    def width(self) -> int:
        return self.adj.shape[1]


def make_graph(capacity: int, width: int) -> GraphArrays:
    return GraphArrays(
        adj=jnp.full((capacity, width), -1, dtype=jnp.int32),
        deg=jnp.zeros((capacity,), dtype=jnp.int32),
    )


def set_rows(g: GraphArrays, ids: jax.Array, rows: jax.Array) -> GraphArrays:
    """Overwrite whole adjacency rows (forward edges of freshly inserted
    points — their rows are empty, matching insert_neighbors' first loop,
    nsw.rs:101-103). ``rows`` entries < 0 are padding."""
    counts = jnp.sum((rows >= 0).astype(jnp.int32), axis=-1)
    safe = jnp.where(ids >= 0, ids, g.capacity)  # drop invalid
    adj = g.adj.at[safe].set(rows, mode="drop")
    deg = g.deg.at[safe].set(counts, mode="drop")
    return GraphArrays(adj, deg)


class AppendResult(NamedTuple):
    graph: GraphArrays
    # per-flattened-edge bookkeeping, sorted by target:
    targets: jax.Array  # int32[E] sorted target ids (invalid -> capacity)
    sources: jax.Array  # int32[E] new-point ids aligned with targets
    cols: jax.Array  # int32[E] column each edge was stored at (clamped)
    written: jax.Array  # bool[E] actually stored (False = dropped: row full)
    incoming: jax.Array  # int32[capacity+1] per-target incoming count
    pos: jax.Array  # int32[E] unclamped landing position (>= W: overflow)


def append_reverse_edges(
    g: GraphArrays, targets: jax.Array, sources: jax.Array
) -> AppendResult:
    """Batched reverse-edge append: for each (target, source) pair, place
    ``source`` into ``adj[target]`` after the current degree. Pairs with
    target < 0 are ignored. Appends that would overflow the row width are
    dropped (the prune pass then rebuilds those rows from scratch).
    """
    cap, W = g.adj.shape
    t = jnp.where(targets >= 0, targets, cap).astype(jnp.int32)
    s = sources.astype(jnp.int32)

    # sort by (target, source) for deterministic grouped placement
    t, s = jax.lax.sort((t, s), num_keys=2)
    idx = jnp.arange(t.shape[0], dtype=jnp.int32)
    run_start = jnp.concatenate(
        [jnp.ones((1,), bool), t[1:] != t[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(run_start, idx, 0))
    rank = idx - seg_start

    pos = g.deg[jnp.clip(t, 0, cap - 1)] + rank
    ok = (t < cap) & (pos < W)
    row = jnp.where(ok, t, cap)
    col = jnp.clip(pos, 0, W - 1)
    adj = g.adj.at[row, col].set(s, mode="drop")
    deg = g.deg.at[row].add(ok.astype(jnp.int32), mode="drop")

    incoming = jnp.zeros((cap + 1,), jnp.int32).at[t].add(1, mode="drop")
    return AppendResult(GraphArrays(adj, deg), t, s, col, ok, incoming, pos)


def prune_rows(
    g: GraphArrays,
    node_ids: jax.Array,
    node_pts: jax.Array,
    nbr_pts: jax.Array,
    m_max: int,
    metric,
    extra_ids: jax.Array | None = None,
    extra_pts: jax.Array | None = None,
) -> GraphArrays:
    """Re-run the diversity heuristic over each listed node's neighborhood
    and rebuild its row — the degree-cap prune of insert_neighbors
    (nsw.rs:105-128: candidates = current neighbors, select_neighbors at
    m_max, clear_edges + add_neighbors).

    Args:
      node_ids: int32[P] nodes to prune (< 0 entries are skipped).
      node_pts: [P, ...] the nodes' own points.
      nbr_pts:  [P, W, ...] gathered points of each node's current row.
      extra_ids/extra_pts: optional [P, X] spilled candidates (reverse
        edges that could not be appended because the row was already
        full, -1 padded) — the batched analogue of the reference's rule
        that the incoming edge participates in the prune's candidate set
        (nsw.rs:113-127: candidates include the just-added edge).
    """
    cap, W = g.adj.shape
    safe = jnp.clip(node_ids, 0, cap - 1)
    rows = g.adj[safe]  # [P, W]
    valid = (rows >= 0) & (node_ids[:, None] >= 0)
    if extra_ids is not None:
        rows = jnp.concatenate([rows, extra_ids], axis=1)
        valid = jnp.concatenate(
            [valid, (extra_ids >= 0) & (node_ids[:, None] >= 0)], axis=1
        )
        nbr_pts = jnp.concatenate([nbr_pts, extra_pts], axis=1)

    def one(npt, row, v, cpts):
        d = metric.one_to_many(npt, cpts)
        pair = metric.pairwise(cpts, cpts)
        sel_ids, _, n_sel = select_neighbors(d, row, pair, v, m_max)
        return sel_ids, n_sel

    sel_rows, n_sel = jax.vmap(one)(node_pts, rows, valid, nbr_pts)

    pad = W - m_max
    if pad > 0:
        sel_rows = jnp.concatenate(
            [sel_rows, jnp.full((sel_rows.shape[0], pad), -1, jnp.int32)],
            axis=-1,
        )
    tgt = jnp.where(node_ids >= 0, node_ids, cap)
    adj = g.adj.at[tgt].set(sel_rows, mode="drop")
    deg = g.deg.at[tgt].set(n_sel, mode="drop")
    return GraphArrays(adj, deg)
