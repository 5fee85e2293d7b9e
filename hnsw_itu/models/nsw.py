"""NSW — single-layer navigable small world index.

Parity target: ``NSWBuilder`` / ``NSW`` (reference/src/index/nsw.rs:
186-352). The first inserted point becomes the entry point (nsw.rs:300-313);
queries run one beam search from it and take the k best (nsw.rs:341-351).
Construction is the bulk-synchronous chunk loop of ``extend_parallel``
(nsw.rs:224-277) re-expressed as batched device steps (models/_build.py),
with a progressive chunk schedule replacing the 50k sequential warmup.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import GraphArrays, make_graph
from ..ops import beam_kernel
from ..ops.entry import sampled_entry
from ..ops.metrics import get_metric
from ..ops.search import batched_beam_search
from . import _build
from .base import (ID_INF, IndexOptions, KnnResult, LazyStats,
                   device_memory_limit)


def _pad_rows(x: np.ndarray, to: int):
    if x.shape[0] == to:
        return x
    pad = np.zeros((to - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0)


def _pad_rows_j(x: jax.Array, to: int) -> jax.Array:
    """Device-side row padding (no host round trip)."""
    if x.shape[0] == to:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((to - x.shape[0], *x.shape[1:]), x.dtype)], axis=0
    )


def _dev_i32(obj, name: str, val: int) -> jax.Array:
    """Cached device scalar on ``obj``: a fresh ``jnp.int32(v)`` per knns
    batch is an eager host-to-device copy. ep/n are fixed once an index is
    built, so upload each value once."""
    cache = getattr(obj, "_scalar_cache", None)
    if cache is None:
        cache = obj._scalar_cache = {}
    hit = cache.get(name)
    if hit is None or hit[0] != val:
        hit = (val, jnp.int32(val))
        cache[name] = hit
    return hit[1]


def _trim_rows_j(x: jax.Array, to: int) -> jax.Array:
    """x[:to], skipping the identity slice (every eager device op is its
    own program launch)."""
    return x if x.shape[0] == to else x[:to]


def _batch_pad(b: int, B: int) -> int:
    """Padded size of a b-query batch (B = the index's query_batch): full
    batches stay, a partial one rounds up to a power of two so each size
    compiles once."""
    return b if b == B else 1 << (b - 1).bit_length()


@jax.jit
def _remap_ids_j(id_map, ids):
    """Map internal (reordered) ids to original dataset ids, preserving
    the ID_INF 'no result' sentinel (models/base.py)."""
    mapped = id_map[jnp.clip(ids, 0, id_map.shape[0] - 1)]
    return jnp.where(ids == ID_INF, ids, mapped)


def _entry_points(points, qs, ep, n, *, entry_sample, metric):
    if entry_sample > 0 and n is not None:
        return sampled_entry(points, qs, n, sample_size=entry_sample,
                             metric=metric)
    return jnp.full((qs.shape[0],), ep, jnp.int32)


def beam_from_entries(points, adj, adj_pts, qs, eps, *, k, ef, metric,
                      expand, max_steps, dedup="bitmask", tie_bits=0,
                      kernel=False):
    """Base-layer beam search from per-query entry ids, by one of the three
    query paths (``query_path``): the CUDA kernel over the inline rows
    (``kernel``), the XLA loop over the inline rows (``adj_pts`` given), or
    the XLA loop gathering point rows (``adj_pts`` None). Returns
    (dists[:, :k], ids[:, :k], visited, steps)."""
    cap = adj.shape[0]
    ef = max(ef, k)
    if kernel:
        words = int(np.prod(points.shape[1:]))
        d0 = jax.vmap(lambda q, p: metric.one_to_many(q, p[None])[0])(
            qs, points[eps])
        init, id_bits, max_d = beam_kernel.prepare(d0, eps, cap=cap,
                                                   words=words)
        keys, vis, stp = beam_kernel.beam_search(
            adj, adj_pts, qs, init, ef=ef, id_bits=id_bits, max_d=max_d,
            max_steps=max_steps)
        d, i = beam_kernel.decode(keys, id_bits=id_bits, max_d=max_d,
                                  inf=metric.inf, id_inf=ID_INF)
        return d[:, :k], i[:, :k], vis, stp
    res = batched_beam_search(
        lambda ids: points[ids],
        adj,
        qs,
        eps,
        ef=ef,
        metric=metric,
        capacity=cap,
        expand=expand,
        max_steps=max_steps,
        dedup="beam" if adj_pts is not None else dedup,
        get_nbr_pts=None if adj_pts is None else (lambda ids: adj_pts[ids]),
        tie_bits=tie_bits,
    )
    return res.dists[:, :k], res.ids[:, :k], res.visited, res.steps


def _nsw_query(points, adj, adj_pts, qs, ep, n, *, k, ef, metric_name,
               expand, max_steps, dedup, entry_sample, tie_bits, kernel):
    metric = get_metric(metric_name)
    eps = _entry_points(points, qs, ep, n, entry_sample=entry_sample,
                        metric=metric)
    return beam_from_entries(
        points, adj, adj_pts, qs, eps, k=k, ef=ef, metric=metric,
        expand=expand, max_steps=max_steps, dedup=dedup, tie_bits=tie_bits,
        kernel=kernel)


_query_step = jax.jit(
    _nsw_query,
    static_argnames=("k", "ef", "metric_name", "expand", "max_steps",
                     "dedup", "entry_sample", "tie_bits", "kernel"),
)


def plan_query(metric_name: str, cap: int, W: int, words: int, ef: int, *,
               has_rows: bool, use_kernel: bool = True, expand: int = 1,
               tie_bits: int = 0) -> str:
    """The query planner: "kernel" (CUDA beam kernel over the inline rows),
    "inline" (XLA loop over the inline rows) or "gather" (XLA loop over
    random point rows). Decided from what the index holds (an inline table
    exists only when it fit the device, ``enable_inline``), its shapes, and
    whether the kernel runs on this device."""
    if not has_rows:
        return "gather"
    if (
        use_kernel
        and expand == 1
        and beam_kernel.kernel_eligible(metric_name, cap, W, words, ef,
                                        tie_bits)
        and beam_kernel.available()
    ):
        return "kernel"
    return "inline"


def query_path(index, k: int, ef: int) -> str:
    """``plan_query`` for an NSW or HNSW index; ``index.use_kernel = False``
    pins the XLA paths."""
    adj = index.graph.adj if hasattr(index, "graph") else index.base.adj
    return plan_query(
        index.metric.name, adj.shape[0], adj.shape[1],
        int(np.prod(index.points.shape[1:])), max(ef, k),
        has_rows=index.adj_pts is not None, use_kernel=index.use_kernel,
        expand=index.query_expand, tie_bits=index._tie_bits())


# headroom kept free beside the live buffers and a table: the runtime's own
# reservation and a dispatch's temporaries
_MARGIN_BYTES = 1.6e9


# inline budget where the device reports no allocator limit (the CPU)
_UNLIMITED_BUDGET_BYTES = 1.1e10


def _inline_budget(env_var: str, fixed_bytes: int) -> int:
    """Byte budget for an inline table. Where the device reports its
    allocator limit, whatever the fixed live buffers (points/adjacency/
    spill/levels) and a margin leave of it: a larger donated set
    (fixed + table) would fail mid-build. The env knob, when set, is an
    explicit override that can only lower that. Where no limit is reported
    (the CPU), the env knob or its 1.1e10 default stands."""
    env = os.environ.get(env_var)
    limit = device_memory_limit()
    if limit is None:
        return int(float(env or _UNLIMITED_BUDGET_BYTES))
    budget = int(limit - _MARGIN_BYTES - fixed_bytes)
    return budget if env is None else min(budget, int(float(env)))


def _query_fixed_bytes(points, adj) -> int:
    """Live non-table bytes at query time: the point and adjacency arrays.
    Shape/dtype arithmetic (not .nbytes): the sharded path passes
    ShapeDtypeStructs when sizing per-shard tables."""
    return (int(np.prod(points.shape)) * points.dtype.itemsize
            + int(np.prod(adj.shape)) * adj.dtype.itemsize)


def _inline_query_fits(points, adj) -> bool:
    words = int(np.prod(points.shape[1:]))
    need = adj.shape[0] * adj.shape[1] * words * points.dtype.itemsize
    return need <= _inline_budget(
        "HNSW_INLINE_QUERY_BYTES", _query_fixed_bytes(points, adj))


@functools.partial(jax.jit, static_argnames=("inline_words",))
def _materialize_inline(points, adj, inline_words: int = 0):
    """Inline neighbor rows, stored FLAT [cap, W*words] (row e holds the
    sketches of e's W neighbours back to back, one contiguous read per
    expansion).

    ``inline_words`` > 0 stores TRUNCATED prefixes (the large-N build
    regime; see _build.search_select).

    Tiled, so no [cap*W, words] gather intermediate is materialized."""
    cap, W = adj.shape
    words = int(np.prod(points.shape[1:]))
    mw = inline_words or words
    tile = max(1, min(cap, 16384))
    n_tiles = -(-cap // tile)
    out = jnp.zeros((cap, W * mw), points.dtype)

    def body(i, out):
        start = i * tile  # dynamic_slice clamps the tail tile (overlap ok)
        a = jax.lax.dynamic_slice_in_dim(adj, start, tile, 0)
        g = points[jnp.clip(a, 0, points.shape[0] - 1)]
        g = g.reshape(tile, W, words)[:, :, :mw]
        return jax.lax.dynamic_update_slice(
            out, g.reshape(tile, W * mw), (start, 0)
        )

    return jax.lax.fori_loop(0, n_tiles, body, out)


class NSW:
    """Immutable search-side index."""

    def __init__(self, points, n, graph: GraphArrays, ep, metric, opts=None):
        self.points = points
        self.n = int(n)
        self.graph = graph
        self.ep = int(ep) if ep is not None else None
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.opts = opts or IndexOptions()
        self.query_expand = 1
        self.query_batch = 1024
        self.query_dedup = "bitmask"
        self.query_entry_sample = 0  # >0: matmul sampled entry (ops/entry.py)
        # tie order of the XLA beam: "auto" = bit-reversed ids iff the index
        # was BFS-reordered (plain id ties there keep entry-proximal nodes);
        # "id" / "bitrev" pin either order for A/B runs
        self.query_tie = "auto"
        self.max_steps = None  # None = auto (2*ef, the measured safe cap)
        self.use_kernel = True  # CUDA beam kernel when query_path allows
        self.last_stats = None
        self.adj_pts = None
        self.id_map = None  # int32[cap] new->original id (set by reorder)

    def size(self) -> int:
        return self.n

    def reorder(self, order: str = "bfs") -> None:
        """Relabel nodes for memory locality (ops/reorder.py): BFS rank from
        the entry point becomes the new id, so each expansion's neighbor
        rows sit near the expanded node in the point/adjacency/inline
        tables. Pure isomorphic relabel — results are mapped back to
        original dataset ids through ``id_map`` inside ``knns``. Fetches
        the live adjacency to the host once (~130 MB per million nodes at
        W=32)."""
        if order != "bfs":
            raise ValueError(f"unknown reorder {order!r}; known: bfs")
        if self.ep is None or self.n <= 1:
            return
        from ..ops.reorder import bfs_order, full_permutation, window_shuffle

        adj_np = np.asarray(self.graph.adj[: self.n])
        order = bfs_order(adj_np, self.n, self.ep)
        # ops escape hatch: shuffle ranks within windows to break the
        # rank<->geometry tie bias while keeping locality (see
        # ops/reorder.window_shuffle); 0 disables
        win = int(os.environ.get("HNSW_REORDER_SHUFFLE", 0))
        order = window_shuffle(order, win)
        perm, inv = full_permutation(order, self.graph.capacity)
        self._apply_perm(jnp.asarray(perm), jnp.asarray(inv))

    def _apply_perm(self, permj, invj) -> None:
        from ..ops.reorder import permute_base

        self.points, adj, deg, self.adj_pts = permute_base(
            self.points, self.graph.adj, self.graph.deg, self.adj_pts,
            permj, invj,
        )
        self.graph = GraphArrays(adj, deg)
        self.ep = int(invj[self.ep])
        # id_map composes: existing (new->orig) permuted by the new perm
        self.id_map = (
            permj if self.id_map is None else self.id_map[permj]
        )

    def _steps_cap(self, ef: int) -> int:
        # stragglers past ~ef expansions contribute no recall (measured)
        # but gate the whole lockstep batch; 2*ef is a safe margin
        return self.max_steps if self.max_steps else max(2 * ef, 64)

    def _tie_bits(self) -> int:
        """Resolved tie-decorrelation bits for the XLA beam: 0 = plain
        (d, id) order; >0 = order ties by bit-reversed id. "auto" turns it
        on exactly when the index was reordered (id_map set) — plain-order
        tables break ties randomly w.r.t. geometry already, while BFS rank
        makes low id = entry-proximal."""
        tie = self.query_tie
        if tie == "id" or (tie == "auto" and self.id_map is None):
            return 0
        if tie not in ("auto", "bitrev"):
            raise ValueError(f"unknown query_tie {tie!r}")
        return max(1, (self.graph.capacity - 1).bit_length())

    def enable_inline(self) -> None:
        """Materialize adj_pts (flat inline neighbor rows): each expansion
        then reads one contiguous row instead of W random point rows, on
        the XLA inline path and the CUDA kernel alike. Costs ~W x points
        memory; no-op if it would not fit the device, and idempotent."""
        if self.adj_pts is None and _inline_query_fits(self.points,
                                                       self.graph.adj):
            self.adj_pts = _materialize_inline(self.points, self.graph.adj)

    def search(self, query, k: int, ef: int) -> KnnResult:
        r = self.knns(np.asarray(query)[None], k, ef)
        return KnnResult(r.dists[0], r.ids[0])

    def knns(self, queries, k: int, ef: int) -> KnnResult:
        """Batched queries — the rayon par_iter analogue
        (src/index/mod.rs:27-43): queries become a leading array axis.
        Uploaded to the device once; batches are sliced on device."""
        if self.ep is None:
            raise ValueError("empty index")
        qs = queries if isinstance(queries, jax.Array) else jnp.asarray(
            np.asarray(queries)
        )
        nq = qs.shape[0]
        B = self.query_batch
        path = query_path(self, k, ef)
        out_d, out_i, out_v, out_s = [], [], [], []
        for s in range(0, nq, B):
            q = qs if nq <= B else qs[s : s + B]
            b = q.shape[0]
            d, i, vis, st = _query_step(
                self.points,
                self.graph.adj,
                None if path == "gather" else self.adj_pts,
                _pad_rows_j(q, _batch_pad(b, B)),
                _dev_i32(self, "ep", self.ep),
                _dev_i32(self, "n", self.n),
                k=k,
                ef=ef,
                metric_name=self.metric.name,
                expand=self.query_expand,
                max_steps=self._steps_cap(ef),
                dedup=self.query_dedup,
                entry_sample=self.query_entry_sample,
                tie_bits=self._tie_bits(),
                kernel=path == "kernel",
            )
            # results stay on device: callers np.asarray what they
            # consume (usually just ids), stats fetch lazily
            out_d.append(_trim_rows_j(d, b))
            out_i.append(_trim_rows_j(i, b))
            out_v.append(_trim_rows_j(vis, b))
            out_s.append(_trim_rows_j(st, b))
        cat = (lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs))
        self.last_stats = LazyStats(cat(out_v), cat(out_s), nq)
        ids = cat(out_i)
        if self.id_map is not None:  # reordered index: original ids out
            ids = _remap_ids_j(self.id_map, ids)
        return KnnResult(cat(out_d), ids)


class NSWBuilder:
    """Batched construction (extend_parallel parity, nsw.rs:224-277)."""

    def __init__(self, options: IndexOptions | None = None, metric="hamming"):
        self.opts = options or IndexOptions()
        if self.opts.size <= 0:
            raise ValueError("IndexOptions.size must be set (preallocation)")
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.n = 0
        self.ep = None
        self.points = None  # allocated on first extend
        self.graph = make_graph(self.opts.size, self.opts.max_connections)
        self._node_map = jnp.arange(self.opts.size, dtype=jnp.int32)
        self.adj_pts = None  # inline rows maintained during the build
        self.inline_words = 0  # >0: adj_pts holds truncated prefixes
        self.spill = _build.make_spill(self.opts.size)  # overflow recovery
        self.edge_drops = []  # per-chunk reverse-edge drop counts (device)
        self._sealed = False  # set by a reorder build; see _check_unsealed

    def total_edge_drops(self) -> int:
        """Reverse edges lost to full rows across the whole build
        (unrecoverable by the prune pass; see _build.apply_inserts)."""
        return int(sum(int(np.asarray(d)) for d in self.edge_drops))

    def _grow_capacity(self, need: int) -> None:
        """Vec-growth parity (the reference's graph grows on push,
        simplegraph.rs:82-87): when extend passes the preallocated
        capacity, reallocate at the next power-of-two >= need and
        continue instead of raising. Static-shape kernels recompile once
        per doubling — the same amortized-copy contract as a Vec realloc.
        The inline-row width (``inline_words``) chosen at first
        allocation is kept: re-evaluating the budget at the new size
        could shrink the prefix mid-build and mix estimate precisions in
        one graph. Shared by HNSWBuilder (base layer; its level arrays
        already grow via _grow_level)."""
        import dataclasses

        cap = self.opts.size
        new = max(1, cap)
        while new < need:
            new *= 2
        if new == cap:
            return
        pad = new - cap
        self.opts = dataclasses.replace(self.opts, size=new)
        self._node_map = jnp.arange(new, dtype=jnp.int32)
        is_nsw = hasattr(self, "graph")
        g = self.graph if is_nsw else self.base
        g = GraphArrays(
            jnp.concatenate(
                [g.adj, jnp.full((pad, g.adj.shape[1]), -1, jnp.int32)]
            ),
            jnp.concatenate([g.deg, jnp.zeros((pad,), jnp.int32)]),
        )
        if is_nsw:
            self.graph = g
        else:
            self.base = g
        # spill is [cap+1, X] with the scatter junk row LAST; the old junk
        # row holds garbage and must NOT become node ``cap``'s live spill
        X = self.spill.shape[1]
        self.spill = jnp.concatenate(
            [self.spill[:-1], jnp.full((pad + 1, X), -1, jnp.int32)]
        )
        if self.points is not None:
            self.points = jnp.concatenate([
                self.points,
                jnp.zeros((pad, *self.points.shape[1:]), self.points.dtype),
            ])
        if self.adj_pts is not None:
            self.adj_pts = jnp.concatenate([
                self.adj_pts,
                jnp.zeros((pad, self.adj_pts.shape[1]), self.adj_pts.dtype),
            ])

    # -- allocation ---------------------------------------------------------
    def _inline_build_words(self, sample: np.ndarray) -> int:
        """Width (in point words) of the inline build rows: full sketches
        when they fit the build budget, else the widest TRUNCATED prefix
        that does (construction searches then run on estimated distances
        with an exact re-score before select — see _build.search_select),
        else 0 (no inline buffer; searches pay random gathers)."""
        words = int(np.prod(sample.shape[1:]))
        # donated buffers are updated in place, so adj_pts mutations do not
        # hold two generations and the build budget matches the query-side
        # one. Build quality is very sensitive to this width (fewer prefix
        # bits = noisier estimates steering the construction beam). The
        # donated fixed set rides alongside the inline rows, so the budget
        # is capped to what the device holds (points + adj + deg + spill +
        # temporaries margin).
        fixed = self.opts.size * (
            words * sample.dtype.itemsize
            + self.opts.max_connections * 4  # adj rows
            + 4                              # deg
            + 32                             # spill (8 x int32 / row)
        )
        # HNSW: level arrays ride alongside (HNSWBuilder._extra_fixed_bytes)
        fixed += getattr(self, "_extra_fixed_bytes", lambda: 0)()
        budget = _inline_budget("HNSW_INLINE_BUILD_BYTES", fixed)
        per_word = (
            self.opts.size * self.opts.max_connections * sample.dtype.itemsize
        )
        if words * per_word <= budget:
            return words
        mw = int(budget // per_word)
        # below 64 prefix bits the estimates are too noisy to steer the
        # beam; fall back to the gather path instead of a bad graph
        return mw if mw >= 2 else 0

    def _inline_build_fits(self, sample: np.ndarray) -> bool:
        return self._inline_build_words(sample) == int(
            np.prod(sample.shape[1:])
        )

    def _ensure_points(self, sample: np.ndarray):
        self._check_unsealed()
        if self.points is None:
            self.points = jnp.zeros(
                (self.opts.size, *sample.shape[1:]), dtype=sample.dtype
            )
            words = int(np.prod(sample.shape[1:]))
            mw = self._inline_build_words(sample)
            self.inline_words = 0 if mw == words else mw
            if mw > 0:
                self.adj_pts = jnp.zeros(
                    (self.opts.size, self.opts.max_connections * mw),
                    dtype=sample.dtype,
                )

    # -- IndexBuilder parity ---------------------------------------------------
    def add(self, point) -> None:
        self.extend(np.asarray(point)[None], sequential=True)

    def extend(self, points, sequential: bool = True) -> None:
        """Sequential insert loop (Extend parity, nsw.rs:279-285): chunks of
        one point; exact reference insert ordering."""
        pts = np.asarray(points)
        self._ensure_points(pts)
        if sequential:
            for row in pts:
                self._insert_chunk(row[None])
        else:
            self.extend_batched(pts)

    def extend_batched(self, points, progress=None) -> None:
        """extend_parallel parity: host-native sequential warmup
        (nsw.rs:234-235), then progressive batched search-then-mutate
        chunks. ``progress`` (optional) is called with the running row
        count after the warmup and after every chunk."""
        pts = np.asarray(points)
        self._ensure_points(pts)
        off = self._host_warmup(pts)
        if off and progress:
            progress(off)
        if self.ep is None and pts.shape[0] > off:
            self._insert_chunk(pts[off : off + 1])
            off += 1
        max_chunk = self.opts.batch_size * 16
        sched = _build.chunk_schedule(
            self.n, pts.shape[0] - off, max_chunk=max_chunk
        )
        i = 0
        while i < len(sched):
            c = sched[i]
            G = self._scan_group(sched, i, max_chunk)
            if G > 1:
                self._insert_chunks_scanned(pts[off : off + G * c], G, c)
            else:
                self._insert_chunk(pts[off : off + c])
            off += G * c
            i += G
            if progress:
                progress(off)

    def _scan_group(self, sched, i: int, max_chunk: int) -> int:
        """Scanned-dispatch group size at schedule position i
        (_build.scan_group_at; also used unbound by HNSWBuilder)."""
        if not NSWBuilder._scanned_fits(self):  # unbound: HNSWBuilder too
            return 1
        return _build.scan_group_at(
            sched, i, max_chunk, self.opts.scan_group,
            entry_ready=(self.opts.entry_sample > 0
                         and self.n > self.opts.entry_sample),
        )

    def _scanned_fits(self) -> bool:
        """A scanned G-chunk program may hold a second copy of the inline
        table as a temporary beside the donated live set; where the device
        reports its limit and live buffers + that copy + a margin exceed
        it, fall back to per-chunk dispatches (G=1)."""
        limit = device_memory_limit()
        if self.adj_pts is None or limit is None:
            return True
        g = self.graph if hasattr(self, "graph") else self.base
        live = (self.points.nbytes + g.adj.nbytes + g.deg.nbytes
                + self.spill.nbytes + self.adj_pts.nbytes)
        return live + self.adj_pts.nbytes + 1.0e9 <= limit

    def _insert_chunks_scanned(self, chunk: np.ndarray, G: int, c: int):
        """G full equal chunks in ONE dispatch (_build.chunk_steps_scanned)
        — bit-identical to G ``_insert_chunk`` calls, minus G-1 program
        launches."""
        if self.n + G * c > self.opts.size:
            self._grow_capacity(self.n + G * c)
        n0 = self.n
        S = min(self.opts.batch_size, c)
        (self.points, self.graph, self.adj_pts, self.spill,
         dropped) = _build.chunk_steps_scanned(
            self.points,
            self._node_map,
            self.graph,
            self.adj_pts,
            self.spill,
            jnp.asarray(chunk),
            jnp.asarray(n0 + np.arange(G * c, dtype=np.int32)),
            jnp.asarray(n0 + c * np.arange(G, dtype=np.int32)),
            G=G,
            cp=c,
            S=S,
            efc=self.opts.ef_construction,
            m=self.opts.connections,
            metric_name=self.metric.name,
            expand=self.opts.expand,
            prune_budget=min(self.opts.size,
                             max(self.opts.prune_budget, c)),
            entry_sample=self.opts.entry_sample,
            inline_words=self.inline_words,
        )
        self.n += G * c
        self.edge_drops.append(dropped)
        if self.adj_pts is not None and self.adj_pts.nbytes > 1 << 30:
            # throttle queue-ahead dispatch (see _insert_chunk)
            np.asarray(self.graph.deg[:1])

    def _host_warmup(self, pts: np.ndarray) -> int:
        """Insert the first ``host_warmup`` points on the CPU with exact
        reference insert semantics (native/hnsw_host.cpp), then upload."""
        from .. import native

        warm = min(self.opts.host_warmup, pts.shape[0])
        if (
            self.n > 0
            or warm < 2
            or self.metric.name not in native.METRIC_CODE
            or not native.available()
        ):
            return 0
        cap, W = self.opts.size, self.opts.max_connections
        pts_np = np.zeros((cap, *pts.shape[1:]), pts.dtype)
        pts_np[:warm] = pts[:warm]
        adj_np = np.full((cap, W), -1, np.int32)
        deg_np = np.zeros((cap,), np.int32)
        native.host_build(
            pts_np, self.metric.name, adj_np, deg_np, 1, warm,
            m=self.opts.connections, efc=self.opts.ef_construction, ep=0,
        )
        # free the pre-warmup zero buffers BEFORE uploading replacements:
        # nothing queued references them yet, and holding old+new doubles
        # peak device memory (the inline rows alone are ~10 GB at 2M)
        self.points.delete()
        self.points = jnp.asarray(pts_np)
        self.graph.adj.delete()
        self.graph.deg.delete()
        self.graph = GraphArrays(jnp.asarray(adj_np), jnp.asarray(deg_np))
        if self.adj_pts is not None:
            self.adj_pts.delete()
            self.adj_pts = _materialize_inline(
                self.points, self.graph.adj, self.inline_words
            )
        self.ep = 0
        self.n = warm
        return warm

    def _check_unsealed(self) -> None:
        """A reorder build permutes the builder's arrays into the NEW id
        space and sets a fresh id_map on the index; re-running build() (or
        extending) would reorder the already-permuted arrays and emit an
        id_map into the FIRST relabel's space — knns would then silently
        return wrong ids. Refuse instead."""
        if self._sealed:
            raise RuntimeError(
                "builder is sealed after a reorder build: further "
                "extend/build would compose relabels and corrupt the "
                "id_map; create a new builder (or set reorder=False and "
                "call index.reorder() yourself)"
            )

    def build(self) -> NSW:
        self._check_unsealed()
        self._drain_spill()
        # spill entries never drained by a prune are lost for good: count
        # them as drops so the logged rate stays honest
        self.edge_drops.append(jnp.sum((self.spill[:-1] >= 0).astype(jnp.int32)))
        nsw = NSW(self.points, self.n, self.graph, self.ep, self.metric,
                  self.opts)
        had_inline = self.adj_pts is not None
        if had_inline:
            # drain the async build queue first: pending chunk steps still
            # reference the old buffer and deleting/reallocating under them
            # doubles peak memory (OOMs at 1M)
            np.asarray(self.graph.deg[:1])
            # free the builder's scatter-chain copy BEFORE any relabel —
            # reorder's permutation temporaries must not coexist with the
            # truncated build buffer (~10GB at 10M) — then rebuild fresh
            # from points+adj: peak memory stays at one copy and the fresh
            # array carries the gather-preferred layout
            self.adj_pts.delete()
            self.adj_pts = None
        if self.opts.reorder:
            nsw.reorder()  # BEFORE tables: they build from reordered arrays
            # resync the builder to the relabeled arrays — otherwise it
            # pins the pre-permute points/adjacency for its lifetime
            # alongside the new query tables (see HNSWBuilder.build).
            self.points, self.graph, self.ep = nsw.points, nsw.graph, nsw.ep
            self.spill = jnp.full_like(self.spill, -1)
            self._sealed = True
        if had_inline:
            nsw.enable_inline()  # fresh inline rows
        return nsw

    # -- internals ------------------------------------------------------------
    def _drain_spill(self, max_passes: int = 4):
        """Prune-only passes that consume leftover spill entries. A chunk
        whose new spills outnumber its prune budget defers them (boosted
        rows drain in the NEXT chunk's prune) — after the last chunk there
        is no next chunk, so drain explicitly before sealing the index."""
        if self.points is None:
            return
        budget = min(self.opts.size,
                     max(self.opts.prune_budget, self.opts.batch_size * 16))
        for _ in range(max_passes):
            if not bool(np.asarray(jnp.any(self.spill[:-1] >= 0))):
                break
            self.graph, self.adj_pts, self.spill, _ = _build.apply_inserts(
                self.points, self._node_map, self.graph,
                jnp.full((1,), -1, jnp.int32),
                jnp.full((1, 1), -1, jnp.int32),
                self.adj_pts, self.spill,
                metric_name=self.metric.name, prune_budget=budget,
                inline_words=self.inline_words,
            )

    def _insert_chunk(self, chunk: np.ndarray):
        """One bulk-synchronous round in ONE device dispatch
        (_build.chunk_step): point write + entry block + all search windows
        + the mutation."""
        c = chunk.shape[0]
        if self.n + c > self.opts.size:
            self._grow_capacity(self.n + c)
        first = self.ep is None
        n0 = self.n
        if first:
            # first point becomes the entry point (nsw.rs:300-313)
            self.points = _build.write_points(
                self.points, jnp.asarray(chunk[:1]), jnp.int32(n0)
            )
            self.ep = n0
            self.n += 1
            chunk = chunk[1:]
            n0 += 1
            c -= 1
            if c == 0:
                return

        S = 1 if c == 1 else min(self.opts.batch_size, 1 << (c - 1).bit_length())
        cp = -(-c // S) * S
        qj = jnp.asarray(_pad_rows(chunk, cp))
        new_ids = n0 + np.arange(cp, dtype=np.int32)
        new_ids[c:] = -1
        use_entry = (
            self.opts.entry_sample > 0 and n0 > self.opts.entry_sample
        )
        step_fn = (_build.chunk_step_split
                   if os.environ.get("HNSW_SPLIT_CHUNK") == "1"
                   else _build.chunk_step)  # see HNSWBuilder._insert_graph
        (self.points, self.graph, self.adj_pts, self.spill,
         dropped) = step_fn(
            self.points,
            self._node_map,
            self.graph,
            self.adj_pts,
            self.spill,
            qj,
            jnp.asarray(new_ids),
            jnp.int32(n0),
            jnp.int32(self.ep),
            jnp.int32(c),
            S=S,
            efc=self.opts.ef_construction,
            m=self.opts.connections,
            metric_name=self.metric.name,
            expand=self.opts.expand,
            # scale the prune budget with the chunk: a fixed 256 dropped
            # 11% of reverse edges at 2M (5.4M drops) and cost ~4 recall
            # points; one prune slot per inserted row bounds the loss
            prune_budget=min(self.opts.size,
                             max(self.opts.prune_budget, cp)),
            entry_sample=self.opts.entry_sample,
            use_entry=use_entry,
            inline_words=self.inline_words,
        )
        self.n += c
        self.edge_drops.append(dropped)  # device scalars, summed lazily
        if self.adj_pts is not None and self.adj_pts.nbytes > 1 << 30:
            # throttle queue-ahead dispatch: with multi-GB inline buffers,
            # letting many chunk mutations queue up accumulates donated
            # output allocations and OOMs; one tiny fetch drains the queue
            np.asarray(self.graph.deg[:1])
