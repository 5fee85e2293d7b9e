"""Greedy beam search over a padded-adjacency graph (SEARCH-LAYER, Alg. 2).

Parity target: ``nsw::search`` (reference/src/index/nsw.rs:133-184).
The reference walks the graph with two MinMaxHeaps (candidates + bounded
result beam ``w``) and a HashSet visited set. Array-native redesign:

* one fixed-capacity beam, kept sorted ascending by (distance, id) — it is
  simultaneously the candidate heap (unexpanded entries) and the result set
  ``w`` (all entries), so the reference's "candidate enters cands iff it
  enters w" pruning rule (nsw.rs:167-176) is the merge-and-truncate itself;
* an "expanded" flag per beam slot replaces pop_min: each step expands the
  ``expand`` best unexpanded entries at once (E-way frontier expansion keeps
  the device busy; E=1 reproduces the reference's exact expansion order);
* the visited HashSet (nsw.rs:143) becomes a packed bitmask (ops/bitset.py);
* termination — "nearest candidate farther than worst result"
  (nsw.rs:152-154) — becomes: no unexpanded entry with d <= beam-worst.

One difference vs the reference: entries evicted from ``w`` stay in the
reference's unbounded candidate heap and may still be expanded; here eviction
discards them. At equal ef this measures slightly lower recall; callers can
raise ef (the beam is the only memory the search needs, so ef is cheap).

The whole loop is a ``lax.while_loop`` with static shapes, vmap-able over a
query batch — queries in one batch run in lockstep until all terminate
(the device analogue of rayon's par_iter over queries, src/index/mod.rs:36-41).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import bitset
from .metrics import Metric

ID_INF = jnp.iinfo(jnp.int32).max


class SearchResult(NamedTuple):
    """Fixed-shape search output: ascending (distance, id), padded with
    (dtype-max, ID_INF). ``visited``/``steps`` mirror the reference's
    per-query instrumentation (nsw.rs:180-181)."""

    dists: jax.Array
    ids: jax.Array
    visited: jax.Array
    steps: jax.Array


def bitrev_ids(x, bits: int):
    """Bijective involution on [0, 2**bits): reverse the low ``bits`` bits.

    The beam's (d, id) lex order breaks distance ties by id, and after a
    BFS locality reorder (ops/reorder.py) low id == entry-proximal — so
    ties systematically keep entry-near candidates and the beam loses
    exploration depth. Encoding the ORDERING id as the bit-reversal of the
    real id breaks that correlation (adjacent ranks land 2**(bits-1)
    apart) while the tables keep the BFS locality: encode before every key
    compare, decode (same function — it is an involution) at the
    expansion fetch. Runs on uint32 so the shifts stay logical; callers
    guarantee x < 2**bits on lanes they consume (masked lanes may hold
    garbage).
    """
    x = x.astype(jnp.uint32)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = (x >> 16) | (x << 16)
    return (x >> (32 - bits)).astype(jnp.int32)


def _tie_enc(ids, tie_bits: int, valid):
    """Encode ids into the tie-decorrelated ordering space (``bitrev_ids``).
    Applied only where ``valid``; sentinel/invalid lanes pass through. The
    encode is an involution, so the same function decodes."""
    if not tie_bits:
        return ids
    return jnp.where(valid, bitrev_ids(ids, tie_bits), ids)


def beam_search(
    get_points: Callable[[jax.Array], jax.Array],
    adj: jax.Array,
    q: jax.Array,
    ep: jax.Array,
    *,
    ef: int,
    metric: Metric,
    capacity: int,
    expand: int = 1,
    max_steps: int = 2048,
    dedup: str = "bitmask",
    get_nbr_pts: Callable[[jax.Array], jax.Array] | None = None,
    tie_bits: int = 0,
) -> SearchResult:
    """Search one query on one graph layer.

    Args:
      get_points: ids int32[C] (clamped in-range) -> point rows [C, ...].
      adj: int32[capacity, W] padded adjacency; entries < 0 are "no edge"
           (the array analogue of Vec<HashSet<Idx>>, simplegraph.rs:10-14).
      q: one query point.
      ep: entry-point id (scalar int32).
      ef: beam width (result size).
      expand: how many unexpanded beam entries to expand per step.
      max_steps: safety bound on the while_loop trip count.
      dedup: "bitmask" keeps an exact O(capacity/32) visited bit-vector per
        query (the reference's HashSet, nsw.rs:143); "beam" drops it and
        dedups by id inside the merge sort instead — no O(N) state per
        query (crucial for large batches on big indexes), at the cost of
        occasionally re-expanding a node that was evicted and rediscovered.
      get_nbr_pts: optional inline-neighbor fetch: ids int32[E] (the
        expanded nodes) -> [E, W, ...] the points of their whole adjacency
        rows, stored contiguously. Turns W random 128B point gathers per
        expansion into one sequential multi-KB row read — the bandwidth-friendly
        layout. Requires dedup="beam" (candidate order must stay aligned
        with the inline rows).
      tie_bits: > 0 orders equal-distance ties by BIT-REVERSED id
        (``bitrev_ids``) instead of raw id. Needed for recall on
        BFS-reordered tables, where low id == entry-proximal and plain id
        ties systematically evict true neighbors. Returned ids are real
        either way.

    Returns SearchResult with arrays of length ef.
    """
    if get_nbr_pts is not None and dedup != "beam":
        raise ValueError("inline neighbor points require dedup='beam'")
    if tie_bits and capacity > (1 << tie_bits):
        raise ValueError(f"capacity={capacity} > 2**tie_bits")
    if dedup == "beam":
        max_d = metric.max_distance(q)
        if max_d is not None:
            id_bits = max(1, (capacity - 1).bit_length())
            if id_bits + (max_d + 1).bit_length() <= 31:
                return _beam_search_packed(
                    get_points, adj, q, ep, ef=ef, metric=metric,
                    capacity=capacity, expand=expand, max_steps=max_steps,
                    get_nbr_pts=get_nbr_pts, max_d=max_d, id_bits=id_bits,
                    tie_bits=tie_bits,
                )
    inf = metric.inf
    W = adj.shape[1]
    E = expand
    C = E * W  # candidates per step

    # ep: scalar, or [E0] of DISTINCT per-query entry seeds (multi-seed
    # entry); E0 <= ef
    eps_raw = jnp.atleast_1d(jnp.asarray(ep, jnp.int32))
    E0 = eps_raw.shape[0]
    d_eps = metric.one_to_many(q, get_points(eps_raw))
    # the beam carries ORDERING ids (tie-encoded when tie_bits > 0);
    # ids are decoded at every adjacency/point gather and at the end
    eps_o = _tie_enc(eps_raw, tie_bits, jnp.ones((E0,), bool))
    d_eps, eps_o = jax.lax.sort((d_eps, eps_o), num_keys=2)

    beam_d = jnp.full((ef,), inf, metric.dist_dtype).at[0:E0].set(d_eps)
    beam_i = jnp.full((ef,), ID_INF, jnp.int32).at[0:E0].set(eps_o)
    beam_x = jnp.zeros((ef,), bool)
    if dedup == "bitmask":
        visited = bitset.insert(
            bitset.make(capacity), eps_raw, jnp.ones((E0,), bool)
        )
    else:
        visited = jnp.zeros((0,), jnp.uint32)  # unused carry placeholder

    def worst(bd):
        return bd[ef - 1]

    def cond(state):
        bd, bi, bx, vis, nvis, step = state
        frontier = (~bx) & (bd <= worst(bd)) & (bd < inf)
        return (step < max_steps) & jnp.any(frontier)

    def body(state):
        bd, bi, bx, vis, nvis, step = state

        # -- select the E best unexpanded entries (beam is sorted, so the
        #    first E unexpanded are the (d, id)-smallest: pop_min parity).
        unexp_rank = jnp.cumsum((~bx).astype(jnp.int32)) - 1
        sel_mask = (~bx) & (unexp_rank < E) & (bd < inf)
        pos_score = jnp.where(sel_mask, jnp.arange(ef), ef + 1)
        neg_top, _ = jax.lax.top_k(-pos_score, E)
        sel_pos = -neg_top  # E smallest positions, padded with ef+1
        sel_ok = sel_pos < ef
        sel_pos_c = jnp.clip(sel_pos, 0, ef - 1)
        bx = bx.at[sel_pos].set(True, mode="drop")
        sel_ids = jnp.where(sel_ok, bi[sel_pos_c], ID_INF)
        sel_raw = _tie_enc(sel_ids, tie_bits, sel_ids != ID_INF)

        # -- gather neighbor lists  [E, W] -> [C]
        nbr = adj[jnp.clip(sel_raw, 0, capacity - 1)]
        nbr = jnp.where((nbr >= 0) & sel_ok[:, None], nbr, ID_INF)
        nid = nbr.reshape(C)

        if dedup == "bitmask":
            # -- dedup within the step (sort; equal-to-previous are dupes)
            nid = jax.lax.sort(nid)
            is_dup = jnp.concatenate(
                [jnp.zeros((1,), bool), nid[1:] == nid[:-1]]
            )
            in_range = nid < capacity
            fresh = in_range & (~is_dup) & (~bitset.contains(vis, nid))
            vis = bitset.insert(vis, nid, fresh)
            nvis = nvis + jnp.sum(fresh.astype(jnp.int32))

            pts = get_points(jnp.clip(nid, 0, capacity - 1))
            cd = metric.one_to_many(q, pts)
            cd = jnp.where(fresh, cd, inf)
            ci = _tie_enc(jnp.where(fresh, nid, ID_INF), tie_bits, fresh)

            # -- merge into beam: two-key sort by (d, id), truncate to ef.
            #    This applies the reference's insert rule exactly: a
            #    candidate survives iff it beats the current worst once the
            #    beam is full (nsw.rs:167-176), with (distance, key)
            #    tie-break (mod.rs:90-96).
            md = jnp.concatenate([bd, cd])
            mi = jnp.concatenate([bi, ci])
            mx = jnp.concatenate([bx, jnp.zeros((C,), bool)])
            md, mi, mx = jax.lax.sort((md, mi, mx), num_keys=2)
        else:
            # -- visited-free: distances for all candidates, then dedup by
            #    id inside the merge (keep the expanded copy so nothing is
            #    re-expanded while it stays in the beam). A two-sort merge
            #    avoids the vmapped [B, C, C] broadcast compare.
            if get_nbr_pts is not None:
                # inline rows arrive FLAT [E, W*words]; unflatten to points
                pts = get_nbr_pts(jnp.clip(sel_raw, 0, capacity - 1))
                pts = pts.reshape(C, *q.shape)
            else:
                pts = get_points(jnp.clip(nid, 0, capacity - 1))
            cd = metric.one_to_many(q, pts)
            cd = jnp.where(nid < capacity, cd, inf)
            ci = _tie_enc(jnp.where(nid < capacity, nid, ID_INF), tie_bits,
                          nid < capacity)

            md = jnp.concatenate([bd, cd])
            mi = jnp.concatenate([bi, ci])
            mx = jnp.concatenate([bx, jnp.zeros((C,), bool)])
            is_cand = jnp.concatenate(
                [jnp.zeros((ef,), bool), jnp.ones((C,), bool)]
            )
            # sort by (id, expanded first, beam before candidate); kill
            # equal-id successors
            notx = (~mx).astype(jnp.int32)
            mi, notx, is_cand, md, mx = jax.lax.sort(
                (mi, notx, is_cand, md, mx), num_keys=3
            )
            dup = jnp.concatenate(
                [jnp.zeros((1,), bool), mi[1:] == mi[:-1]]
            )
            # validity by sentinel, not `< capacity`: tie-encoded ids can
            # exceed capacity (bitrev maps into [0, 2**tie_bits))
            nvis = nvis + jnp.sum(
                ((~dup) & is_cand & (mi != ID_INF)).astype(jnp.int32)
            )
            md = jnp.where(dup, inf, md)
            mi = jnp.where(dup, ID_INF, mi)
            mx = jnp.where(dup, False, mx)
            md, mi, mx = jax.lax.sort((md, mi, mx), num_keys=2)
        return md[:ef], mi[:ef], mx[:ef], vis, nvis, step + 1

    beam_d, beam_i, beam_x, visited, n_visited, steps = jax.lax.while_loop(
        cond, body,
        (beam_d, beam_i, beam_x, visited, jnp.int32(E0), jnp.int32(0)),
    )
    beam_i = _tie_enc(beam_i, tie_bits, beam_i != ID_INF)  # decode
    return SearchResult(beam_d, beam_i, n_visited, steps)


def _beam_search_packed(
    get_points,
    adj,
    q,
    ep,
    *,
    ef,
    metric,
    capacity,
    expand,
    max_steps,
    get_nbr_pts,
    max_d,
    id_bits,
    tie_bits=0,
) -> SearchResult:
    """Beam search with (distance, id) packed into ONE int32 sort key —
    ``key = (d << id_bits) | id``. The packed order equals the reference's
    (distance, key) order (mod.rs:90-96), the beam carry shrinks to
    (key, expanded), and every bitonic sort moves half the operands.
    Applicable when the metric has a static distance bound (Hamming:
    words*32) and dist_bits + id_bits <= 31. ``tie_bits`` > 0 packs the
    BIT-REVERSED id into the key (see beam_search); tie_bits <= id_bits
    always holds since both derive from the same capacity.
    """
    E = expand
    W = adj.shape[1]
    C = E * W
    SHIFT = jnp.int32(1 << id_bits)
    MASK = jnp.int32((1 << id_bits) - 1)
    KEY_INF = jnp.int32((max_d + 1) << id_bits)

    eps_raw = jnp.atleast_1d(jnp.asarray(ep, jnp.int32))
    E0 = eps_raw.shape[0]
    d_eps = metric.one_to_many(q, get_points(eps_raw)).astype(jnp.int32)
    eps_o = _tie_enc(eps_raw, tie_bits, jnp.ones((E0,), bool))
    bk0 = jnp.full((ef,), KEY_INF, jnp.int32).at[0:E0].set(
        jax.lax.sort((d_eps << id_bits) | eps_o)
    )
    bx0 = jnp.zeros((ef,), bool)

    def cond(state):
        bk, bx, nvis, step = state
        frontier = (~bx) & (bk <= bk[ef - 1]) & (bk < KEY_INF)
        return (step < max_steps) & jnp.any(frontier)

    def body(state):
        bk, bx, nvis, step = state

        unexp_rank = jnp.cumsum((~bx).astype(jnp.int32)) - 1
        sel_mask = (~bx) & (unexp_rank < E) & (bk < KEY_INF)
        pos_score = jnp.where(sel_mask, jnp.arange(ef), ef + 1)
        neg_top, _ = jax.lax.top_k(-pos_score, E)
        sel_pos = -neg_top
        sel_ok = sel_pos < ef
        sel_pos_c = jnp.clip(sel_pos, 0, ef - 1)
        bx = bx.at[sel_pos].set(True, mode="drop")
        sel_keys = bk[sel_pos_c]
        sel_ids = jnp.where(
            sel_ok & (sel_keys < KEY_INF), sel_keys & MASK, ID_INF
        )
        sel_raw = _tie_enc(sel_ids, tie_bits, sel_ids != ID_INF)

        nbr = adj[jnp.clip(sel_raw, 0, capacity - 1)]
        nbr = jnp.where((nbr >= 0) & (sel_ids != ID_INF)[:, None], nbr, -1)
        nid = nbr.reshape(C)

        if get_nbr_pts is not None:
            # inline rows arrive FLAT [E, W*words]; unflatten to points
            pts = get_nbr_pts(jnp.clip(sel_raw, 0, capacity - 1))
            pts = pts.reshape(C, *q.shape)
        else:
            pts = get_points(jnp.clip(nid, 0, capacity - 1))
        cd = metric.one_to_many(q, pts).astype(jnp.int32)
        nid_o = _tie_enc(nid, tie_bits, nid >= 0)
        ck = jnp.where(nid >= 0, (cd << id_bits) | nid_o, KEY_INF)

        mk = jnp.concatenate([bk, ck])
        mx = jnp.concatenate([bx, jnp.zeros((C,), bool)])
        is_cand = jnp.concatenate(
            [jnp.zeros((ef,), bool), jnp.ones((C,), bool)]
        )
        # equal id => equal distance => equal key: dedup on the packed key,
        # keeping the expanded copy first and a beam copy before a
        # candidate copy (so a rediscovered beam entry is not counted as
        # visited — the order is total, not left to the sort's stability)
        notx = (~mx).astype(jnp.int32)
        mk, notx, is_cand, mx = jax.lax.sort(
            (mk, notx, is_cand, mx), num_keys=3
        )
        dup = jnp.concatenate([jnp.zeros((1,), bool), mk[1:] == mk[:-1]])
        nvis = nvis + jnp.sum(
            ((~dup) & is_cand & (mk < KEY_INF)).astype(jnp.int32)
        )
        mk = jnp.where(dup, KEY_INF, mk)
        mx = jnp.where(dup, False, mx)
        mk, mx = jax.lax.sort((mk, mx), num_keys=1)
        return mk[:ef], mx[:ef], nvis, step + 1

    bk, bx, n_visited, steps = jax.lax.while_loop(
        cond, body, (bk0, bx0, jnp.int32(E0), jnp.int32(0))
    )
    valid = bk < KEY_INF
    dists = jnp.where(valid, bk >> id_bits, metric.inf)
    ids = jnp.where(valid, bk & MASK, ID_INF)
    ids = _tie_enc(ids, tie_bits, valid)  # decode
    return SearchResult(dists, ids, n_visited, steps)


def greedy_search(get_points, adj, q, ep, *, metric, capacity, max_steps=512):
    """ef=1 greedy descent — the upper-layer walk of HNSW::search
    (src/index/hnsw.rs:285-293). Returns (dist, id) of the local minimum."""
    r = beam_search(
        get_points,
        adj,
        q,
        ep,
        ef=1,
        metric=metric,
        capacity=capacity,
        expand=1,
        max_steps=max_steps,
    )
    return r.dists[0], r.ids[0]


def batched_beam_search(
    get_points,
    adj,
    queries,
    eps,
    *,
    ef: int,
    metric: Metric,
    capacity: int,
    expand: int = 1,
    max_steps: int = 2048,
    dedup: str = "bitmask",
    get_nbr_pts=None,
    tie_bits: int = 0,
) -> SearchResult:
    """vmap of beam_search over a query batch (and per-query entry points)."""
    fn = partial(
        beam_search,
        get_points,
        adj,
        ef=ef,
        metric=metric,
        capacity=capacity,
        expand=expand,
        max_steps=max_steps,
        dedup=dedup,
        get_nbr_pts=get_nbr_pts,
        tie_bits=tie_bits,
    )
    return jax.vmap(fn)(queries, eps)
