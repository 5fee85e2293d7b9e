"""Bulk-synchronous batched graph construction — shared by NSW and HNSW.

Parity target: the parallel-search / sequential-mutate chunk loop of
``extend_parallel`` (reference/src/index/nsw.rs:224-277,
reference/src/index/hnsw.rs:43-170). Per chunk the reference runs a
read-only parallel phase (search + select-neighbors per point over the
pre-chunk graph) and then a sequential mutation phase (edge writes +
degree-cap prunes). The batched device analogue:

  phase 1 (search_select): one vmapped beam search + vectorized
    select-neighbors over a sub-batch of chunk points — the rayon par_iter
    becomes a leading batch axis;
  phase 2 (apply_inserts): vectorized forward-row writes, grouped
    reverse-edge append, and a budgeted batch of degree-cap prunes — the
    sequential insert_neighbors loop (nsw.rs:94-131) becomes three scatters.

Deviations (bulk-synchronous relaxations, documented):
  * prunes see a whole chunk's incoming edges at once instead of one insert
    at a time; reverse edges beyond the row width that the prune budget
    doesn't cover are dropped (the reference's own parallel build already
    relaxes insert ordering chunk-wide);
  * the unconditional post-prune re-add of the new edge (nsw.rs:129) is
    only partially subsumed: incoming ids that fit the target row DO
    participate in the prune's candidate set, but reverse edges dropped by
    ``append_reverse_edges`` because the target row was already full never
    enter the row and are unconditionally lost (beyond the prune-budget
    relaxation). ``apply_inserts`` counts these drops so builders can log
    the rate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import GraphArrays, append_reverse_edges, prune_rows, set_rows
from ..ops.entry import sampled_entry
from ..ops.metrics import get_metric
from ..ops.search import batched_beam_search
from ..ops.select import select_neighbors


@functools.partial(
    jax.jit,
    static_argnames=("efc", "m", "metric_name", "expand", "max_steps", "dedup",
                     "inline_words"),
    donate_argnums=(),
)
def search_select(
    points,
    node_map,
    adj,
    qs,
    q_valid,
    eps,
    adj_pts=None,
    *,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    dedup: str = "beam",
    inline_words: int = 0,
):
    """Phase 1: for a sub-batch of new points, beam-search the current graph
    (ef=ef_construction) and diversity-select up to m neighbors each —
    ``search_select_neighbors`` (nsw.rs:44-58), batched.

    Args:
      points: [cap_pts, ...] point buffer (new points already written).
      node_map: int32[cap_graph] graph-local id -> point row (identity for
        flat graphs; upper HNSW layers map local ids to base points).
      adj: int32[cap_graph, W] adjacency to search.
      qs: [S, ...] new points' data.
      q_valid: bool[S] padding mask.
      eps: int32[S] per-point entry node (graph-local).
      inline_words: >0 means adj_pts holds TRUNCATED sketches (the first
        inline_words words per neighbor) — the >full-inline-budget build
        regime. The beam then searches on ESTIMATED (prefix) distances and
        the beam candidates are re-scored EXACTLY before select (the
        candidate points are gathered for the pairwise matmul step anyway).

    Returns sel_ids int32[S, m] (graph-local, -1 padded) and their dists.
    """
    metric = get_metric(metric_name)
    cap_graph = adj.shape[0]

    def get_points(ids):
        return points[node_map[ids]]

    if inline_words:
        pts_t = points.reshape(points.shape[0], -1)[:, :inline_words]
        qs_t = qs.reshape(qs.shape[0], -1)[:, :inline_words]
        get_search_points = lambda ids: pts_t[node_map[ids]]  # noqa: E731
    else:
        qs_t = qs
        get_search_points = get_points

    res = batched_beam_search(
        get_search_points,
        adj,
        qs_t,
        eps,
        ef=efc,
        metric=metric,
        capacity=cap_graph,
        expand=expand,
        max_steps=max_steps,
        dedup="beam" if adj_pts is not None else dedup,
        get_nbr_pts=(
            None if adj_pts is None else (lambda ids: adj_pts[ids])
        ),
    )

    IINF = np.iinfo(np.int32).max

    def sel_one(q, bd, bi, ok):
        valid = (bi != IINF) & (bd < metric.inf) & ok
        cpts = get_points(jnp.clip(bi, 0, cap_graph - 1))
        if inline_words:
            # exact re-score + (d, id) resort: the estimated order from the
            # truncated search is not the select order
            bd = jnp.where(valid, metric.one_to_many(q, cpts), metric.inf)
            bi = jnp.where(valid, bi, IINF)
            perm = jnp.arange(bi.shape[0], dtype=jnp.int32)
            bd, bi, perm = jax.lax.sort((bd, bi, perm), num_keys=2)
            cpts = cpts[perm]
            valid = (bi != IINF) & (bd < metric.inf)
        pair = metric.pairwise_mxu(cpts, cpts)
        sel_ids, sel_d, _ = select_neighbors(bd, bi, pair, valid, m)
        return sel_ids, sel_d

    sel_ids, sel_d = jax.vmap(sel_one)(qs, res.dists, res.ids, q_valid)
    sel_ids = jnp.where(q_valid[:, None], sel_ids, -1)
    return sel_ids, sel_d


# spill buffer width shared by every build path (single-chip, mesh-sharded,
# dryrun, tests) — one constant so overflow-recovery capacity can never
# silently diverge between paths
SPILL_WIDTH = 8


def make_spill(cap: int, width: int = SPILL_WIDTH) -> jax.Array:
    """Persistent spill buffer: int32[cap+1, width], -1 = empty. Row t
    holds reverse-edge sources bound for node t that could not be appended
    because t's row was full. Entries persist across chunks until t is
    pruned (they then join the prune candidate set and the row is
    cleared). Row cap is the scatter junk row."""
    return jnp.full((cap + 1, width), -1, jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("metric_name", "prune_budget", "inline_words"),
    donate_argnums=(2, 5, 6),
)
def apply_inserts(
    points,
    node_map,
    graph: GraphArrays,
    new_ids,
    sel_rows,
    adj_pts=None,
    spill=None,
    *,
    metric_name: str,
    prune_budget: int = 256,
    inline_words: int = 0,
):
    """Phase 2: vectorized ``insert_neighbors`` (nsw.rs:94-131) for a chunk.

    Args:
      new_ids: int32[c] graph-local ids of the freshly inserted points
        (-1 padding skipped).
      sel_rows: int32[c, m] selected neighbors per new point (-1 padded).
      adj_pts: optional inline-neighbor rows [cap, W, ...] kept consistent
        with every mutation (forward rows, reverse appends, prunes) so
        construction searches can use the fast sequential-read path.
      spill: optional persistent spill buffer (``make_spill``). Reverse
        edges that could not be appended (target row full) land here and
        join the target's prune candidate set — the batched analogue of
        the reference's rule that the incoming edge participates in the
        prune (nsw.rs:113-127). Rows holding spill entries get prune
        priority, and pruned rows' spill entries are cleared (adopted or
        rejected on merit). None disables the spill pass.

    Returns (graph, adj_pts, spill, n_dropped). n_dropped counts reverse
    edges UNRECOVERABLY lost: spilled past the buffer width. (Edges the
    prune's diversity heuristic rejects on merit are not drops — the
    reference prunes them the same way.)
    """
    metric = get_metric(metric_name)
    cap, W = graph.adj.shape

    def pts_of(ids):
        return points[node_map[jnp.clip(ids, 0, cap - 1)]]

    def inline_of(ids):
        """Point data as stored in adj_pts rows (truncated when
        inline_words > 0, see search_select)."""
        p = pts_of(ids)
        return p[..., :inline_words] if inline_words else p

    # forward edges: the new point's whole row (its row was empty)
    pad = W - sel_rows.shape[1]
    rows = sel_rows
    if pad > 0:
        rows = jnp.concatenate(
            [rows, jnp.full((rows.shape[0], pad), -1, jnp.int32)], axis=-1
        )
    deg_before = graph.deg
    graph = set_rows(graph, new_ids, rows)
    if adj_pts is not None:
        # adj_pts rows are FLAT [cap, W*inline] (one contiguous row each)
        n_new = rows.shape[0]
        safe_new = jnp.where(new_ids >= 0, new_ids, cap)
        adj_pts = adj_pts.at[safe_new].set(
            inline_of(rows).reshape(n_new, -1), mode="drop"
        )

    # reverse edges, grouped append
    c, m = sel_rows.shape
    targets = sel_rows.reshape(-1)
    sources = jnp.broadcast_to(new_ids[:, None], (c, m)).reshape(-1)
    targets = jnp.where((sources >= 0) & (targets >= 0), targets, -1)
    res = append_reverse_edges(graph, targets, sources)
    graph = res.graph
    if adj_pts is not None:
        row_t = jnp.where(res.written, res.targets, cap)
        src_pts = inline_of(res.sources)
        src_flat = src_pts.reshape(src_pts.shape[0], -1)
        words = src_flat.shape[1]
        col0 = res.cols[:, None] * words + jnp.arange(words)[None, :]
        adj_pts = adj_pts.at[row_t[:, None], col0].set(src_flat, mode="drop")

    # spill: overflowed reverse edges (pos >= W) land AFTER any entries
    # already spilled onto that row in earlier chunks
    spilled = (~res.written) & (res.targets < cap)
    spill_cnt = None
    if spill is not None:
        X = spill.shape[1]
        spill_cnt = jnp.sum((spill >= 0).astype(jnp.int32), axis=1)  # [cap+1]
        srank = res.pos - W + spill_cnt[jnp.clip(res.targets, 0, cap)]
        s_ok = spilled & (srank < X)
        spill = spill.at[
            jnp.where(s_ok, res.targets, cap), jnp.clip(srank, 0, X - 1)
        ].set(res.sources, mode="drop")
        spill_cnt = jnp.sum((spill >= 0).astype(jnp.int32), axis=1)
        n_dropped = jnp.sum((spilled & ~s_ok).astype(jnp.int32))
    else:
        n_dropped = jnp.sum(spilled.astype(jnp.int32))

    # budgeted degree-cap prune of overfull receivers (nsw.rs:105-130);
    # rows carrying spill entries outrank plain overfull rows so stuck
    # spills drain at budget rate instead of persisting forever
    demand = deg_before + res.incoming[:cap]
    over = jnp.where(demand > W, demand, 0)
    if spill_cnt is not None:
        over = jnp.where(
            spill_cnt[:cap] > 0, (W + 1 + spill_cnt[:cap]) << 8, over
        )
    prune_budget = min(prune_budget, cap)
    _, prune_ids = jax.lax.top_k(over, prune_budget)
    prune_ids = jnp.where(over[prune_ids] > 0, prune_ids, -1).astype(jnp.int32)

    safe = jnp.clip(prune_ids, 0, cap - 1)
    node_pts = points[node_map[safe]]
    nbr_rows = graph.adj[safe]
    nbr_pts = pts_of(nbr_rows)
    if spill is not None:
        extra_ids = spill[safe]  # [P, X]
        extra_ids = jnp.where(prune_ids[:, None] >= 0, extra_ids, -1)
        extra_pts = pts_of(extra_ids)
        graph = prune_rows(
            graph, prune_ids, node_pts, nbr_pts, W, metric,
            extra_ids=extra_ids, extra_pts=extra_pts,
        )
        # pruned rows' spills are consumed (adopted or rejected on merit)
        spill = spill.at[jnp.where(prune_ids >= 0, prune_ids, cap)].set(
            -1, mode="drop"
        )
    else:
        graph = prune_rows(graph, prune_ids, node_pts, nbr_pts, W, metric)
    return graph, adj_pts, spill, n_dropped


@functools.partial(
    jax.jit,
    static_argnames=(
        "S", "efc", "m", "metric_name", "expand", "max_steps", "dedup",
        "inline_words",
    ),
)
def search_select_window(
    points,
    node_map,
    adj,
    qs_full,
    eps_full,
    start,
    n_valid,
    adj_pts=None,
    *,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    dedup: str = "beam",
    inline_words: int = 0,
):
    """Device-resident windowed search_select: slices an S-query window out
    of the full (padded) chunk ON DEVICE. Keeps the whole chunk loop free of
    per-window host transfers and eager ops."""
    qs = jax.lax.dynamic_slice_in_dim(qs_full, start, S, axis=0)
    eps = jax.lax.dynamic_slice_in_dim(eps_full, start, S, axis=0)
    valid = (start + jnp.arange(S, dtype=jnp.int32)) < n_valid
    return search_select(
        points,
        node_map,
        adj,
        qs,
        valid,
        eps,
        adj_pts,
        efc=efc,
        m=m,
        metric_name=metric_name,
        expand=expand,
        max_steps=max_steps,
        dedup=dedup,
        inline_words=inline_words,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "S", "efc", "m", "metric_name", "expand", "max_steps",
        "prune_budget", "entry_sample", "use_entry", "do_write",
        "inline_words",
    ),
    donate_argnums=(0, 2, 3, 4),
)
def chunk_step(
    points,
    node_map,
    graph: GraphArrays,
    adj_pts,
    spill,
    chunk,
    new_ids,
    n0,
    ep,
    n_valid,
    *,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    prune_budget: int = 256,
    entry_sample: int = 0,
    use_entry: bool = False,
    do_write: bool = True,
    inline_words: int = 0,
):
    """One WHOLE construction chunk in a single dispatch: point write,
    entry selection, every search window (lax.map over the window grid),
    and the vectorized mutation: one program launch per chunk instead of
    one per window (~200 per 50k points).

    Args:
      chunk: [cp, ...] padded chunk rows (cp a multiple of S).
      new_ids: int32[cp] graph-local ids (-1 padding).
      n0: first point row of the chunk (points write offset when do_write;
        also the sampled-entry population bound).
      ep: global entry point (used when use_entry=False).
      n_valid: number of real rows in the chunk.
      do_write: False when the caller already wrote the chunk's points
        (HNSW writes whole chunks before splitting into level groups whose
        rows are non-contiguous).

    Returns (points, graph, adj_pts, spill, n_dropped).
    """
    metric = get_metric(metric_name)
    if do_write:
        points = write_points(points, chunk, n0)
    cp = chunk.shape[0]
    if use_entry:
        eps_full = sampled_entry(
            points, chunk, n0, sample_size=entry_sample, metric=metric
        )
    else:
        # ep is a scalar (global entry) or an int32[cp] per-row vector
        # (HNSW descent chain)
        eps_full = jnp.broadcast_to(
            jnp.asarray(ep, jnp.int32).reshape(-1), (cp,)
        )

    def real_win(s):
        qs = jax.lax.dynamic_slice_in_dim(chunk, s, S, axis=0)
        eps = jax.lax.dynamic_slice_in_dim(eps_full, s, S, axis=0)
        valid = (s + jnp.arange(S, dtype=jnp.int32)) < n_valid
        sel_ids, _ = search_select(
            points, node_map, graph.adj, qs, valid, eps, adj_pts,
            efc=efc, m=m, metric_name=metric_name, expand=expand,
            max_steps=max_steps, inline_words=inline_words,
        )
        return sel_ids

    def win(i):
        s = i * S
        # bucket padding can leave whole windows past the real rows
        return jax.lax.cond(
            s < n_valid, real_win,
            lambda _: jnp.full((S, m), -1, jnp.int32), s,
        )

    K = cp // S
    if K <= 1:
        sel = real_win(jnp.int32(0))
    else:
        sel = jax.lax.map(win, jnp.arange(K, dtype=jnp.int32))
        sel = sel.reshape(cp, -1)

    graph, adj_pts, spill, dropped = apply_inserts(
        points, node_map, graph, new_ids, sel, adj_pts, spill,
        metric_name=metric_name, prune_budget=prune_budget,
        inline_words=inline_words,
    )
    return points, graph, adj_pts, spill, dropped


@functools.partial(
    jax.jit,
    static_argnames=(
        "S", "efc", "m", "metric_name", "expand", "max_steps",
        "entry_sample", "use_entry", "do_write", "inline_words",
    ),
    donate_argnums=(0,),
)
def chunk_search(
    points,
    node_map,
    adj,
    adj_pts,
    chunk,
    n0,
    ep,
    n_valid,
    *,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    entry_sample: int = 0,
    use_entry: bool = False,
    do_write: bool = True,
    inline_words: int = 0,
):
    """The SEARCH half of ``chunk_step`` as its own program (point write +
    entry block + every search window), for the split-dispatch build mode
    (``chunk_step_split``). Returns (points, sel int32[cp, m])."""
    metric = get_metric(metric_name)
    if do_write:
        points = write_points(points, chunk, n0)
    cp = chunk.shape[0]
    if use_entry:
        eps_full = sampled_entry(
            points, chunk, n0, sample_size=entry_sample, metric=metric
        )
    else:
        eps_full = jnp.broadcast_to(
            jnp.asarray(ep, jnp.int32).reshape(-1), (cp,)
        )

    def real_win(s):
        qs = jax.lax.dynamic_slice_in_dim(chunk, s, S, axis=0)
        eps = jax.lax.dynamic_slice_in_dim(eps_full, s, S, axis=0)
        valid = (s + jnp.arange(S, dtype=jnp.int32)) < n_valid
        sel_ids, _ = search_select(
            points, node_map, adj, qs, valid, eps, adj_pts,
            efc=efc, m=m, metric_name=metric_name, expand=expand,
            max_steps=max_steps, inline_words=inline_words,
        )
        return sel_ids

    def win(i):
        s = i * S
        return jax.lax.cond(
            s < n_valid, real_win,
            lambda _: jnp.full((S, m), -1, jnp.int32), s,
        )

    K = cp // S
    if K <= 1:
        sel = real_win(jnp.int32(0))
    else:
        sel = jax.lax.map(win, jnp.arange(K, dtype=jnp.int32))
        sel = sel.reshape(cp, -1)
    return points, sel


def chunk_step_split(
    points, node_map, graph, adj_pts, spill, chunk, new_ids, n0, ep,
    n_valid, *, S, efc, m, metric_name, expand=1, max_steps=2048,
    prune_budget=256, entry_sample=0, use_entry=False, do_write=True,
    inline_words=0,
):
    """``chunk_step`` as TWO dispatches (search, then mutation). Same
    results and the same per-buffer donation (points in the search
    program; graph/adj_pts/spill in apply_inserts); each half compiles at
    roughly half the program size. Enable with HNSW_SPLIT_CHUNK=1."""
    points, sel = chunk_search(
        points, node_map, graph.adj, adj_pts, chunk, n0, ep, n_valid,
        S=S, efc=efc, m=m, metric_name=metric_name, expand=expand,
        max_steps=max_steps, entry_sample=entry_sample,
        use_entry=use_entry, do_write=do_write, inline_words=inline_words,
    )
    graph, adj_pts, spill, dropped = apply_inserts(
        points, node_map, graph, new_ids, sel, adj_pts, spill,
        metric_name=metric_name, prune_budget=prune_budget,
        inline_words=inline_words,
    )
    return points, graph, adj_pts, spill, dropped


def _scanned_body(
    do_write: bool,
    node_map,
    chunks,
    new_ids,
    n0s,
    eps0=None,
    *,
    G: int,
    cp: int,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int,
    max_steps: int,
    prune_budget: int,
    entry_sample: int,
    inline_words: int,
):
    """Shared fori_loop body factory for the scanned G-chunk dispatchers
    (see ``chunk_steps_scanned``). Returns body(i, carry) where carry is
    (points, graph, adj_pts, spill, drops). ``eps0`` (optional int32
    [G*cp]) supplies per-row entry nodes: rows >= 0 use the supplied
    entry (HNSW's descent-chained upper-level points), rows < 0 fall
    back to the matmul sampled entry."""
    metric = get_metric(metric_name)

    def body(i, carry):
        points, graph, adj_pts, spill, drops = carry
        chunk = jax.lax.dynamic_slice_in_dim(chunks, i * cp, cp, axis=0)
        ids = jax.lax.dynamic_slice_in_dim(new_ids, i * cp, cp, axis=0)
        n0 = n0s[i]
        if do_write:
            points = write_points(points, chunk, n0)
        eps_full = sampled_entry(
            points, chunk, n0, sample_size=entry_sample, metric=metric
        )
        if eps0 is not None:
            sup = jax.lax.dynamic_slice_in_dim(eps0, i * cp, cp, axis=0)
            eps_full = jnp.where(sup >= 0, sup, eps_full)

        def real_win(s):
            qs = jax.lax.dynamic_slice_in_dim(chunk, s, S, axis=0)
            eps = jax.lax.dynamic_slice_in_dim(eps_full, s, S, axis=0)
            valid = jax.lax.dynamic_slice_in_dim(ids, s, S, axis=0) >= 0
            sel_ids, _ = search_select(
                points, node_map, graph.adj, qs, valid, eps, adj_pts,
                efc=efc, m=m, metric_name=metric_name, expand=expand,
                max_steps=max_steps, inline_words=inline_words,
            )
            return sel_ids

        K = cp // S
        if K <= 1:
            sel = real_win(jnp.int32(0))
        else:
            def win(j):
                s = j * S
                # padding rows are a SUFFIX of the group's id vector, so a
                # window is live iff its first row is
                first = jax.lax.dynamic_index_in_dim(
                    ids, s, axis=0, keepdims=False
                )
                return jax.lax.cond(
                    first >= 0, real_win,
                    lambda _: jnp.full((S, m), -1, jnp.int32), s,
                )

            sel = jax.lax.map(win, jnp.arange(K, dtype=jnp.int32))
            sel = sel.reshape(cp, -1)

        graph, adj_pts, spill, dropped = apply_inserts(
            points, node_map, graph, ids, sel, adj_pts, spill,
            metric_name=metric_name, prune_budget=prune_budget,
            inline_words=inline_words,
        )
        return points, graph, adj_pts, spill, drops + dropped

    return body


_SCANNED_STATICS = ("G", "cp", "S", "efc", "m", "metric_name", "expand",
                    "max_steps", "prune_budget", "entry_sample",
                    "inline_words")


@functools.partial(
    jax.jit, static_argnames=_SCANNED_STATICS, donate_argnums=(0, 2, 3, 4)
)
def chunk_steps_scanned(
    points,
    node_map,
    graph: GraphArrays,
    adj_pts,
    spill,
    chunks,
    new_ids,
    n0s,
    *,
    G: int,
    cp: int,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    prune_budget: int = 256,
    entry_sample: int = 1024,
    inline_words: int = 0,
):
    """G equal-shape construction chunks in ONE device dispatch: a
    fori_loop whose body is a whole ``chunk_step`` (write + sampled entry
    + window map + mutation), state carried in place.

    Amortizes the per-launch cost G-fold (a 10M build at max_chunk=16k is
    ~600 steady-state chunk launches). Donated arguments alias in place,
    but the scanned program may hold a temporary copy of the inline
    adj_pts — callers gate G=1 when live buffers + that copy exceed the
    device (NSWBuilder._scanned_fits).

    Semantics: bit-identical to G sequential ``chunk_step`` calls with
    ``use_entry=True`` and full chunks — sub-chunk i's searches see
    sub-chunks < i fully inserted (same bulk-synchronous order).

    Args:
      chunks: [G*cp, ...] stacked chunk rows (each sub-chunk cp rows).
      new_ids: int32[G*cp] graph-local ids; -1 padding must form a SUFFIX.
      n0s: int32[G] per-sub-chunk points-write offset / sampled-entry
        population bound.

    Returns (points, graph, adj_pts, spill, total_dropped).
    """
    body = _scanned_body(
        True, node_map, chunks, new_ids, n0s, G=G, cp=cp, S=S, efc=efc,
        m=m, metric_name=metric_name, expand=expand, max_steps=max_steps,
        prune_budget=prune_budget, entry_sample=entry_sample,
        inline_words=inline_words,
    )
    carry = (points, graph, adj_pts, spill, jnp.int32(0))
    return jax.lax.fori_loop(0, G, body, carry)


@functools.partial(
    jax.jit, static_argnames=_SCANNED_STATICS, donate_argnums=(2, 3, 4)
)
def chunk_steps_scanned_prewritten(
    points,
    node_map,
    graph: GraphArrays,
    adj_pts,
    spill,
    chunks,
    new_ids,
    n0s,
    eps0=None,
    *,
    G: int,
    cp: int,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    prune_budget: int = 256,
    entry_sample: int = 1024,
    inline_words: int = 0,
):
    """``chunk_steps_scanned`` for callers that already wrote the points
    (HNSW writes whole groups up front; level-0 rows are non-contiguous).
    ``points`` is read-only here — not donated, not returned. ``eps0``
    optionally supplies descent-chained entries per row (see
    ``_scanned_body``).

    Returns (graph, adj_pts, spill, total_dropped)."""
    body = _scanned_body(
        False, node_map, chunks, new_ids, n0s, eps0, G=G, cp=cp, S=S,
        efc=efc, m=m, metric_name=metric_name, expand=expand,
        max_steps=max_steps, prune_budget=prune_budget,
        entry_sample=entry_sample, inline_words=inline_words,
    )

    def body_np(i, carry):
        graph, adj_pts, spill, drops = carry
        _, graph, adj_pts, spill, drops = body(
            i, (points, graph, adj_pts, spill, drops)
        )
        return graph, adj_pts, spill, drops

    carry = (graph, adj_pts, spill, jnp.int32(0))
    return jax.lax.fori_loop(0, G, body_np, carry)


@functools.partial(
    jax.jit,
    static_argnames=("S", "efc", "m", "metric_name", "expand", "max_steps",
                     "prune_budget"),
    donate_argnums=(2,),
)
def level_chunk_step(
    points,
    node_ids,
    graph: GraphArrays,
    down,
    chunk,
    new_loc,
    eps,
    n_valid,
    *,
    S: int,
    efc: int,
    m: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
    prune_budget: int = 256,
):
    """One WHOLE upper-level insert group in a single dispatch — the level
    analogue of ``chunk_step`` (hnsw.rs:111-139 per layer). Runs every
    search window (lax.map), filters self-links, applies the mutation, and
    chains the entry points for the level below through ``down``.

    The eager per-window loop this replaces cost one device dispatch per
    window per level.

    Args:
      node_ids: int32[cap_l] local slot -> base point row.
      down: int32[cap_l] local slot -> slot in the level below.
      chunk: [cp, ...] padded group rows.
      new_loc: int32[cp] local slots being inserted (-1 padding).
      eps: int32[cp] per-row entry slot (this level's space).

    Returns (graph, next_eps, n_dropped) with next_eps int32[cp] in the
    LOWER level's id space.
    """
    cap_l = graph.adj.shape[0]
    cp = chunk.shape[0]

    def real_win(s):
        qs = jax.lax.dynamic_slice_in_dim(chunk, s, S, axis=0)
        ep_w = jax.lax.dynamic_slice_in_dim(eps, s, S, axis=0)
        valid = (s + jnp.arange(S, dtype=jnp.int32)) < n_valid
        sel_ids, _ = search_select(
            points, node_ids, graph.adj, qs, valid, ep_w, None,
            efc=efc, m=m, metric_name=metric_name, expand=expand,
            max_steps=max_steps,
        )
        return sel_ids

    def win(i):
        s = i * S
        return jax.lax.cond(
            s < n_valid, real_win,
            lambda _: jnp.full((S, m), -1, jnp.int32), s,
        )

    K = cp // S
    if K <= 1:
        sel = real_win(jnp.int32(0))
    else:
        sel = jax.lax.map(win, jnp.arange(K, dtype=jnp.int32))
        sel = sel.reshape(cp, -1)

    # never link a node to itself (reachable only when this group seeded a
    # brand-new layer and searched from its own first slot)
    sel = jnp.where(sel == new_loc[:, None], -1, sel)

    graph, _, _, dropped = apply_inserts(
        points, node_ids, graph, new_loc, sel, None,
        make_spill(cap_l),  # per-group spill: levels are small
        metric_name=metric_name, prune_budget=prune_budget,
    )
    nearest = jnp.clip(sel[:, 0], 0, cap_l - 1)
    next_eps = down[nearest]
    return graph, next_eps, dropped


@functools.partial(
    jax.jit,
    static_argnames=("S", "metric_name", "expand", "max_steps"),
)
def level_descend_step(
    points,
    node_ids,
    adj,
    down,
    chunk,
    eps,
    n_valid,
    *,
    S: int,
    metric_name: str,
    expand: int = 1,
    max_steps: int = 2048,
):
    """Greedy ef=1 descent through ONE level for a whole chunk in a single
    dispatch (hnsw.rs:94-108): windows via lax.map, then follow ``down``."""
    cap_l = adj.shape[0]
    cp = chunk.shape[0]

    def real_win(s):
        qs = jax.lax.dynamic_slice_in_dim(chunk, s, S, axis=0)
        ep_w = jax.lax.dynamic_slice_in_dim(eps, s, S, axis=0)
        valid = (s + jnp.arange(S, dtype=jnp.int32)) < n_valid
        sel_ids, _ = search_select(
            points, node_ids, adj, qs, valid, ep_w, None,
            efc=1, m=1, metric_name=metric_name, expand=expand,
            max_steps=max_steps,
        )
        return sel_ids

    def win(i):
        s = i * S
        return jax.lax.cond(
            s < n_valid, real_win,
            lambda _: jnp.full((S, 1), -1, jnp.int32), s,
        )

    K = cp // S
    if K <= 1:
        sel = real_win(jnp.int32(0))
    else:
        sel = jax.lax.map(win, jnp.arange(K, dtype=jnp.int32))
        sel = sel.reshape(cp, -1)
    return down[jnp.clip(sel[:, 0], 0, cap_l - 1)]


@functools.partial(
    jax.jit, static_argnames=("sample_size", "metric_name")
)
def entry_step(points, qs, n, *, sample_size, metric_name):
    """Jitted matmul sampled-entry (ops/entry.py) for construction searches."""
    return sampled_entry(
        points, qs, n, sample_size=sample_size, metric=get_metric(metric_name)
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def write_points(points, chunk, n):
    """Append a chunk of points into the preallocated buffer at row n."""
    idx = (n + jnp.arange(chunk.shape[0], dtype=jnp.int32))[:, None]
    col = jnp.arange(points.shape[1], dtype=jnp.int32)[None, :]
    return points.at[idx, col].set(chunk, mode="drop")


def scan_group_at(sched, i: int, max_chunk: int, scan_group: int,
                  entry_ready: bool = True) -> int:
    """Group size for a scanned multi-chunk dispatch starting at schedule
    position ``i``: ``scan_group`` consecutive STEADY-STATE chunks (full
    ``max_chunk`` rows, and — for builders using matmul sampled entries —
    the sampled-entry regime already reached) or nothing. Full groups
    only, so the ramp-up adds no new program shapes (each novel shape is
    a fresh compile); leftovers run through the per-chunk path.

    The single gating point for NSWBuilder, HNSWBuilder and
    ShardedNSW.build — their scanned paths must engage identically."""
    if (
        scan_group <= 1
        or not entry_ready
        or sched[i] != max_chunk
        or i + scan_group > len(sched)
        or any(sched[i + j] != max_chunk for j in range(1, scan_group))
    ):
        return 1
    return scan_group


def chunk_schedule(start_n: int, total: int, *, min_chunk=8, max_chunk=4096, growth_div=8):
    """Progressive chunk sizes (powers of two): the batched replacement for the
    reference's 50k sequential warmup + fixed threads*32 chunks
    (nsw.rs:234-237). Early chunks are small so the young graph keeps
    quality; sizes double as the graph grows.
    """
    n = start_n
    out = []
    remaining = total
    while remaining > 0:
        c = max(min_chunk, min(max_chunk, n // growth_div))
        c = 1 << (c - 1).bit_length()  # round up to pow2
        c = min(c, max_chunk)
        take = min(c, remaining)
        out.append(take)
        n += take
        remaining -= take
    return out
