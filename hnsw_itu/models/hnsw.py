"""HNSW — hierarchical navigable small world index.

Parity target: ``HNSWBuilder`` / ``HNSW`` (reference/src/index/hnsw.rs).
Array redesign of the hierarchy: instead of per-layer ``SimpleGraph<(P, Idx)>``
that clones the point into every occupied layer (hnsw.rs:199-205), each
level holds three arrays —

    node_ids: int32[cap_l]  local slot -> base point row   (no duplication)
    down:     int32[cap_l]  local slot -> slot in the level below
                            (level 0's "below" is the base graph)
    graph:    GraphArrays   adjacency over local slots

``down`` is the (P, Idx) down-pointer chain done properly; the reference's
builder actually reuses a layer-l index as the entry point of layer l-1
(hnsw.rs:222-232 — in-range but wrong-space), which works only because any
entry point converges. We chain entry points through ``down`` correctly.

Construction follows extend_parallel (hnsw.rs:43-170): one random level per
chunk (the reference's per-chunk draw, hnsw.rs:65 — chunks of size 1, i.e.
the sequential path, draw per point like hnsw.rs:183-191), descend from the
global entry point with ef=1 greedy searches, then per layer top->down run
the batched search-select phase followed by the vectorized mutation phase.
Search follows HNSW::search (hnsw.rs:278-300): ef=1 greedy descent through
the levels, then a full-ef beam search on the base layer.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import GraphArrays, make_graph
from ..ops.entry import sampled_entry
from ..ops.metrics import get_metric
from ..ops.search import batched_beam_search
from . import _build
from .base import IndexOptions, KnnResult, LazyStats, rng_seed
from .nsw import (_batch_pad, _dev_i32, _pad_rows_j, _trim_rows_j,
                  beam_from_entries, query_path)


class Level(NamedTuple):
    node_ids: jax.Array  # int32[cap_l]
    down: jax.Array  # int32[cap_l]
    graph: GraphArrays


def _make_level(cap: int, width: int) -> Level:
    return Level(
        node_ids=jnp.zeros((cap,), jnp.int32),
        down=jnp.zeros((cap,), jnp.int32),
        graph=make_graph(cap, width),
    )


def _pad_rows(x: np.ndarray, to: int):
    if x.shape[0] == to:
        return x
    pad = np.zeros((to - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0)


def _descent_eps(points, levels, qs, ep, n, *, metric, max_steps, n_levels,
                 level_adj_pts=None, entry_sample=0):
    """Entry points for the base search: matmul sampled entry when enabled,
    else the ef=1 greedy descent through the levels (hnsw.rs:285-293),
    following down-pointers."""
    B = qs.shape[0]
    if entry_sample > 0 and n is not None:
        return sampled_entry(points, qs, n, sample_size=entry_sample,
                             metric=metric)
    eps = jnp.full((B,), ep, jnp.int32)
    for l in range(n_levels - 1, -1, -1):
        node_ids, down, graph = levels[l]
        adj = graph.adj
        cap_l = adj.shape[0]
        lv_pts = None if level_adj_pts is None else level_adj_pts[l]
        res = batched_beam_search(
            lambda ids, ni=node_ids: points[ni[ids]],
            adj,
            qs,
            eps,
            ef=1,
            metric=metric,
            capacity=cap_l,
            expand=1,
            max_steps=max_steps,
            dedup="beam" if lv_pts is not None else "bitmask",
            get_nbr_pts=(
                None if lv_pts is None else (lambda ids, p=lv_pts: p[ids])
            ),
        )
        local_min = jnp.clip(res.ids[:, 0], 0, cap_l - 1)
        eps = down[local_min]
    return eps


def _hnsw_query(
    points,
    levels,
    base_adj,
    qs,
    ep,
    base_adj_pts=None,
    level_adj_pts=None,
    n=None,
    *,
    k,
    ef,
    metric_name,
    expand,
    max_steps,
    n_levels,
    dedup="bitmask",
    entry_sample=0,
    tie_bits=0,
    kernel=False,
):
    """Full HNSW search for one query batch: greedy descent (or matmul sampled
    entry) + base beam by the path ``query_path`` chose (``kernel``: the
    CUDA kernel over ``base_adj_pts``). ``tie_bits`` decorrelates
    base-beam tie order on reordered tables (levels keep local numbering,
    so only the base needs it)."""
    metric = get_metric(metric_name)
    eps = _descent_eps(
        points, levels, qs, ep, n,
        metric=metric, max_steps=max_steps, n_levels=n_levels,
        level_adj_pts=level_adj_pts, entry_sample=entry_sample,
    )
    # base beam search (hnsw.rs:296-299)
    return beam_from_entries(
        points, base_adj, base_adj_pts, qs, eps, k=k, ef=ef, metric=metric,
        expand=expand, max_steps=max_steps, dedup=dedup, tie_bits=tie_bits,
        kernel=kernel)


_hnsw_query_step = jax.jit(
    _hnsw_query,
    static_argnames=("k", "ef", "metric_name", "expand", "max_steps",
                     "n_levels", "dedup", "entry_sample", "tie_bits",
                     "kernel"),
)


class HNSW:
    """Immutable search-side index."""

    def __init__(self, points, n, base: GraphArrays, levels, level_ns, ep,
                 metric, opts=None):
        self.points = points
        self.n = int(n)
        self.base = base
        self.levels = list(levels)  # list[Level], bottom -> top
        self.level_ns = list(level_ns)
        self.ep = int(ep) if ep is not None else None
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.opts = opts or IndexOptions()
        self.query_expand = 1
        self.query_batch = 1024
        self.query_dedup = "bitmask"
        self.query_entry_sample = 0  # >0: matmul sampled entry (ops/entry.py)
        self.query_tie = "auto"  # XLA beam tie order (see NSW.query_tie)
        self.max_steps = None  # None = auto (2*ef, the measured safe cap)
        self.use_kernel = True  # CUDA base-layer beam kernel when eligible
        self.last_stats = None
        self.adj_pts = None
        self.level_adj_pts = None
        self.id_map = None  # int32[cap] new->original id (set by reorder)

    def size(self) -> int:
        return self.n

    def _steps_cap(self, ef: int) -> int:
        return self.max_steps if self.max_steps else max(2 * ef, 64)

    def _tie_bits(self) -> int:
        # see NSW._tie_bits — identical policy over the base capacity
        tie = self.query_tie
        if tie == "id" or (tie == "auto" and self.id_map is None):
            return 0
        if tie not in ("auto", "bitrev"):
            raise ValueError(f"unknown query_tie {tie!r}")
        return max(1, (self.base.capacity - 1).bit_length())

    def enable_inline(self) -> None:
        """Materialize the fast-query tables: flat inline rows for the base
        layer (read by the XLA inline path and the CUDA kernel) when they
        fit the device, and inline rows for every level (levels are small),
        so each expansion is one sequential read instead of W random
        point-row gathers."""
        from .nsw import _inline_query_fits, _materialize_inline

        if self.adj_pts is None and _inline_query_fits(
            self.points, self.base.adj
        ):
            self.adj_pts = _materialize_inline(self.points, self.base.adj)
        if self.level_adj_pts is None:
            # level inline rows only help the greedy descent (sampled-entry
            # queries skip it); budget 1GB total: at 10M the first level
            # alone would be ~4GB.
            words = int(np.prod(self.points.shape[1:]))
            need = sum(
                lv.graph.adj.shape[0] * lv.graph.width * words * 4
                for lv in self.levels
            )
            if need <= 1 << 30:
                self.level_adj_pts = tuple(
                    _materialize_inline(self.points, lv.node_ids[jnp.clip(
                        lv.graph.adj, 0, lv.node_ids.shape[0] - 1)])
                    for lv in self.levels
                )

    def base_ep(self) -> int:
        """Follow the down-pointer chain from the top-level entry point to
        its base id (no greedy descent — a fixed entry for host search)."""
        e = self.ep
        for lv in reversed(self.levels):
            e = int(lv.down[e])
        return e

    def search(self, query, k: int, ef: int) -> KnnResult:
        r = self.knns(np.asarray(query)[None], k, ef)
        return KnnResult(r.dists[0], r.ids[0])

    def knns(self, queries, k: int, ef: int) -> KnnResult:
        if self.ep is None:
            raise ValueError("empty index")
        qs = queries if isinstance(queries, jax.Array) else jnp.asarray(
            np.asarray(queries)
        )
        nq = qs.shape[0]
        B = self.query_batch
        out_d, out_i, out_v, out_s = [], [], [], []
        levels = tuple(self.levels)
        path = query_path(self, k, ef)
        for s in range(0, nq, B):
            q = qs if nq <= B else qs[s : s + B]
            b = q.shape[0]
            d, i, vis, st = _hnsw_query_step(
                self.points,
                levels,
                self.base.adj,
                _pad_rows_j(q, _batch_pad(b, B)),
                _dev_i32(self, "ep", self.ep),
                None if path == "gather" else self.adj_pts,
                self.level_adj_pts,
                _dev_i32(self, "n", self.n),
                k=k,
                ef=ef,
                metric_name=self.metric.name,
                expand=self.query_expand,
                max_steps=self._steps_cap(ef),
                n_levels=len(levels),
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
            from .nsw import _remap_ids_j

            ids = _remap_ids_j(self.id_map, ids)
        return KnnResult(cat(out_d), ids)

    def reorder(self, order: str = "bfs") -> None:
        """BFS-relabel the base layer for memory locality (ops/reorder.py
        — see NSW.reorder). Levels keep their local numbering; only their
        base-id references (``node_ids`` everywhere, ``down`` on the
        bottom level) are remapped."""
        if order != "bfs":
            raise ValueError(f"unknown reorder {order!r}; known: bfs")
        if self.ep is None or self.n <= 1:
            return
        from ..ops.reorder import (bfs_order, full_permutation, permute_base,
                                   window_shuffle)

        cap = self.base.capacity
        adj_np = np.asarray(self.base.adj[: self.n])
        order = bfs_order(adj_np, self.n, self.base_ep())
        order = window_shuffle(
            order, int(os.environ.get("HNSW_REORDER_SHUFFLE", 0))
        )  # see NSW.reorder
        perm, inv = full_permutation(order, cap)
        permj, invj = jnp.asarray(perm), jnp.asarray(inv)
        # (level_adj_pts is level-local and untouched by a base relabel)
        self.points, adj, deg, self.adj_pts = permute_base(
            self.points, self.base.adj, self.base.deg, self.adj_pts,
            permj, invj,
        )
        self.base = GraphArrays(adj, deg)
        new_levels = []
        for li, lv in enumerate(self.levels):
            node_ids = invj[jnp.clip(lv.node_ids, 0, cap - 1)]
            # down maps level-local -> level-below-local ids; only the
            # bottom level's down points into the (relabeled) base
            down = invj[jnp.clip(lv.down, 0, cap - 1)] if li == 0 else lv.down
            new_levels.append(Level(node_ids, down, lv.graph))
        self.levels = new_levels
        if not self.levels:
            # no hierarchy: ep IS a base id (base_ep() returns it), so it
            # must follow the relabel (BFS starts there -> new id 0)
            self.ep = int(invj[self.ep])
        self.id_map = permj if self.id_map is None else self.id_map[permj]


class HNSWBuilder:
    def __init__(self, options: IndexOptions | None = None, metric="hamming"):
        self.opts = options or IndexOptions()
        if self.opts.size <= 0:
            raise ValueError("IndexOptions.size must be set (preallocation)")
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.n = 0
        self.ep = None  # local slot in the top level (base id if no levels)
        self.points = None
        self.base = make_graph(self.opts.size, self.opts.max_connections)
        self.levels: list[Level] = []
        self.level_ns: list[int] = []
        self._node_map = jnp.arange(self.opts.size, dtype=jnp.int32)
        self.adj_pts = None  # inline base rows maintained during the build
        self.inline_words = 0  # >0: adj_pts holds truncated prefixes
        self.spill = _build.make_spill(self.opts.size)  # overflow recovery
        self.edge_drops = []  # per-chunk reverse-edge drop counts (device)
        self._sealed = False  # set by a reorder build; see _check_unsealed
        # deterministic level RNG (hnsw.rs:24-30)
        self._rng = np.random.RandomState(rng_seed(self.opts))
        self._ml = 1.0 / math.log(max(2, self.opts.connections))

    def total_edge_drops(self) -> int:
        """Reverse edges lost to full rows across the whole build
        (unrecoverable by the prune pass; see _build.apply_inserts)."""
        return int(sum(int(np.asarray(d)) for d in self.edge_drops))

    # -- level machinery ------------------------------------------------------
    def _random_level(self) -> int:
        # floor(-ln(U) * 1/ln(m)) — hnsw.rs:37-40
        u = max(self._rng.random_sample(), 1e-12)
        return int(-math.log(u) * self._ml)

    def _level_capacity(self, l: int) -> int:
        """Initial level-l array capacity: 2x the expected occupancy
        (size/m^(l+1)), pow2-rounded — 2.5-4x actual in practice. Level
        counts concentrate tightly (relative sigma ~ (size/m)^-1/2), and
        _grow_level doubles on demand; the old 8x factor cost 1.1GB of
        dead level-0 rows at 10M, memory the inline build buffer needs."""
        m = max(2, self.opts.connections)
        expect = self.opts.size * (m ** -(l + 1))
        cap = max(64, int(2 * expect))
        return 1 << (cap - 1).bit_length()

    def _extra_fixed_bytes(self) -> int:
        """Level arrays ride alongside the donated base-build set — count
        them in the inline-budget fixed set (NSWBuilder._inline_build_words).
        Sum of per-level (adj + deg + node_ids + down) at initial capacity."""
        per_row = self.opts.max_connections * 4 + 12
        return sum(self._level_capacity(l) * per_row
                   for l in range(self.MAX_HOST_LEVELS))

    def _grow_level(self, l: int, need: int):
        lv = self.levels[l]
        cap = lv.graph.adj.shape[0]
        if need <= cap:
            return
        new_cap = max(need, 2 * cap)
        new_cap = 1 << (new_cap - 1).bit_length()
        pad = new_cap - cap
        self.levels[l] = Level(
            node_ids=jnp.concatenate([lv.node_ids, jnp.zeros((pad,), jnp.int32)]),
            down=jnp.concatenate([lv.down, jnp.zeros((pad,), jnp.int32)]),
            graph=GraphArrays(
                adj=jnp.concatenate(
                    [lv.graph.adj, jnp.full((pad, lv.graph.width), -1, jnp.int32)]
                ),
                deg=jnp.concatenate([lv.graph.deg, jnp.zeros((pad,), jnp.int32)]),
            ),
        )

    # -- builder API --------------------------------------------------------
    def _ensure_points(self, sample: np.ndarray):
        self._check_unsealed()
        if self.points is None:
            self.points = jnp.zeros(
                (self.opts.size, *sample.shape[1:]), dtype=sample.dtype
            )
            from .nsw import NSWBuilder

            words = int(np.prod(sample.shape[1:]))
            mw = NSWBuilder._inline_build_words(self, sample)
            self.inline_words = 0 if mw == words else mw
            if mw > 0:
                self.adj_pts = jnp.zeros(
                    (self.opts.size, self.opts.max_connections * mw),
                    dtype=sample.dtype,
                )

    def add(self, point) -> None:
        self.extend(np.asarray(point)[None])

    def extend(self, points) -> None:
        """Sequential inserts: chunks of one, per-point level draw —
        IndexBuilder::add parity (hnsw.rs:183-244)."""
        pts = np.asarray(points)
        self._ensure_points(pts)
        for row in pts:
            self._insert_chunk(row[None])

    def extend_batched(self, points, progress=None) -> None:
        """extend_parallel parity (hnsw.rs:44-169): host-native sequential
        warmup into the base layer, then progressive chunks. Levels are
        drawn PER POINT and the chunk processed in per-level groups — the
        reference's one-draw-per-chunk quirk (hnsw.rs:65) starves the
        hierarchy at device-sized chunks (a 4096-point chunk is one draw),
        which would leave large indexes effectively flat."""
        pts = np.asarray(points)
        self._ensure_points(pts)
        off = self._host_warmup(pts)
        if off and progress:
            progress(off)
        if self.ep is None and pts.shape[0] > 0:
            self._insert_chunk(pts[:1])
            off = 1
        max_chunk = self.opts.batch_size * 16
        sched = _build.chunk_schedule(
            self.n, pts.shape[0] - off, max_chunk=max_chunk
        )
        i = 0
        while i < len(sched):
            from .nsw import NSWBuilder

            c = sched[i]
            # steady state: scan_group chunks per dispatch for the base
            # layer (NSWBuilder._scan_group — same gating)
            G = NSWBuilder._scan_group(self, sched, i, max_chunk)
            chunk = pts[off : off + G * c]
            # write the whole group in ORIGINAL order (ids must match
            # dataset row order), then insert per-level groups
            n0 = self.n
            if self.n + G * c > self.opts.size:
                NSWBuilder._grow_capacity(self, self.n + G * c)
            self.points = _build.write_points(
                self.points, jnp.asarray(chunk), jnp.int32(n0)
            )
            self.n += G * c
            # one draw per point in id order — the SAME RNG stream whether
            # or not chunks are grouped
            levels = np.array([self._random_level() for _ in range(G * c)])
            # highest groups first so new top layers seed correctly; with
            # G > 1 the upper-level groups span the whole G-chunk window
            # (a bulk-synchronous relaxation over <=G*c points: upper
            # points' LEVEL inserts run before the whole window's base
            # inserts — the reference's parallel build relaxes insert
            # order chunk-wide the same way, nsw.rs:224-277). Their base
            # inserts are DEFERRED and merged back at id order into one
            # scanned dispatch, carrying their descent-chained entries.
            deferred = []
            for lvl in sorted(set(levels.tolist()), reverse=True):
                if lvl == 0 and G > 1:
                    continue  # scanned base path below
                mask = levels == lvl
                d = self._insert_registered(
                    chunk[mask],
                    (n0 + np.nonzero(mask)[0]).astype(np.int32),
                    int(lvl),
                    defer_base=G > 1,
                )
                if d is not None:
                    deferred.append(d)
            if G > 1:
                mask = levels == 0
                parts = [(chunk[mask],
                          (n0 + np.nonzero(mask)[0]).astype(np.int32),
                          np.full((int(mask.sum()),), -1, np.int32))
                         ] + deferred
                mchunk = np.concatenate([p[0] for p in parts])
                mids = np.concatenate([p[1] for p in parts])
                meps = np.concatenate(
                    [np.asarray(p[2], np.int32) for p in parts]
                )
                order = np.argsort(mids, kind="stable")
                self._insert_base_scanned(
                    mchunk[order], mids[order], meps[order], c
                )
            off += G * c
            i += G
            if progress:
                progress(off)

    MAX_HOST_LEVELS = 16  # geometric draw: P(level >= 16) ~ m^-16, unreachable

    def _host_warmup(self, pts: np.ndarray) -> int:
        """CPU-native sequential warmup with the FULL hierarchy (exact
        IndexBuilder::add semantics, hnsw.rs:183-244): per-point level
        draws from the builder's deterministic RNG (the same stream the
        sequential device path would consume), greedy descent, per-layer
        insert_idx, base insert — so ``--single-threaded`` (host_warmup =
        size) builds a real HNSW, not a flat graph."""
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
        # point 0 is pinned at the (empty) top level and consumes no draw
        # (hnsw.rs:185-190); one draw per later point, like extend()
        draws = np.zeros((warm,), np.int32)
        draws[1:] = [self._random_level() for _ in range(warm - 1)]
        ml = self.MAX_HOST_LEVELS
        caps = [self._level_capacity(l) for l in range(ml)]
        total = sum(caps)
        lvl_node_ids = np.zeros((total,), np.int32)
        lvl_down = np.zeros((total,), np.int32)
        lvl_adj = np.full((total, W), -1, np.int32)
        lvl_deg = np.zeros((total,), np.int32)
        level_ns = np.zeros((ml,), np.int64)
        _, ep = native.host_build_hnsw(
            pts_np, self.metric.name, adj_np, deg_np, 1, warm,
            m=self.opts.connections, efc=self.opts.ef_construction,
            draws=draws, level_caps=caps, lvl_node_ids=lvl_node_ids,
            lvl_down=lvl_down, lvl_adj=lvl_adj, lvl_deg=lvl_deg,
            level_ns=level_ns, ep=0,
        )
        # free the pre-warmup zero buffers first — holding old+new doubles
        # peak device memory and OOMs large builds (see NSWBuilder._host_warmup)
        self.points.delete()
        self.points = jnp.asarray(pts_np)
        self.base.adj.delete()
        self.base.deg.delete()
        self.base = GraphArrays(jnp.asarray(adj_np), jnp.asarray(deg_np))
        off = 0
        for l in range(ml):
            if level_ns[l] <= 0:
                break
            self.levels.append(Level(
                node_ids=jnp.asarray(lvl_node_ids[off : off + caps[l]]),
                down=jnp.asarray(lvl_down[off : off + caps[l]]),
                graph=GraphArrays(
                    jnp.asarray(lvl_adj[off : off + caps[l]]),
                    jnp.asarray(lvl_deg[off : off + caps[l]]),
                ),
            ))
            self.level_ns.append(int(level_ns[l]))
            off += caps[l]
        if self.adj_pts is not None:
            from .nsw import _materialize_inline

            self.adj_pts.delete()
            self.adj_pts = _materialize_inline(
                self.points, self.base.adj, self.inline_words
            )
        self.ep = int(ep)
        self.n = warm
        return warm

    def _check_unsealed(self) -> None:
        # see NSWBuilder._check_unsealed (identical hazard)
        if self._sealed:
            raise RuntimeError(
                "builder is sealed after a reorder build: further "
                "extend/build would compose relabels and corrupt the "
                "id_map; create a new builder (or set reorder=False and "
                "call index.reorder() yourself)"
            )

    def build(self) -> HNSW:
        self._check_unsealed()
        self._drain_spill()
        # spill entries never drained by a prune are lost: count as drops
        self.edge_drops.append(jnp.sum((self.spill[:-1] >= 0).astype(jnp.int32)))
        # shrink level arrays from build capacity (generous, pow2 of the
        # expectation) to a snug pow2 of the actual node count — the level
        # inline rows would otherwise cost capacity x 8KB each
        trimmed = []
        for lv, nl in zip(self.levels, self.level_ns):
            m = max(8, 1 << max(0, (nl - 1).bit_length()))
            if m < lv.node_ids.shape[0]:
                lv = Level(
                    node_ids=lv.node_ids[:m],
                    down=lv.down[:m],
                    graph=GraphArrays(lv.graph.adj[:m], lv.graph.deg[:m]),
                )
            trimmed.append(lv)
        h = HNSW(
            self.points,
            self.n,
            self.base,
            trimmed,
            self.level_ns,
            self.ep,
            self.metric,
            self.opts,
        )
        had_inline = self.adj_pts is not None
        if had_inline:
            # drain the async build queue, then free the scatter-chain copy
            # BEFORE any relabel (reorder temporaries must not coexist with
            # the ~10GB truncated build buffer at 10M; see NSWBuilder.build)
            np.asarray(self.base.deg[:1])
            self.adj_pts.delete()
            self.adj_pts = None
        if self.opts.reorder:
            h.reorder()  # BEFORE tables: they build from reordered arrays
            # resync the builder to the relabeled arrays — otherwise it
            # pins the pre-permute points/adjacency/levels (~4GB dead device memory
            # at 10M) for its lifetime alongside the new query tables.
            # Leftover spill ids live in the OLD id space and were already
            # drained + counted as drops, so blank them; the builder is
            # SEALED after a reorder build (further extend is unsupported
            # — the trimmed level arrays have no growth headroom), enforced
            # by _check_unsealed.
            self.points, self.base, self.levels = h.points, h.base, h.levels
            self.ep = h.ep
            self.spill = jnp.full_like(self.spill, -1)
            self._sealed = True
        if had_inline:
            h.enable_inline()  # inline rows + level rows
        return h

    def _drain_spill(self, max_passes: int = 4):
        """Prune-only passes on the BASE layer consuming leftover spill
        entries (see NSWBuilder._drain_spill)."""
        if self.points is None:
            return
        budget = min(self.opts.size,
                     max(self.opts.prune_budget, self.opts.batch_size * 16))
        for _ in range(max_passes):
            if not bool(np.asarray(jnp.any(self.spill[:-1] >= 0))):
                break
            self.base, self.adj_pts, self.spill, _ = _build.apply_inserts(
                self.points, self._node_map, self.base,
                jnp.full((1,), -1, jnp.int32),
                jnp.full((1, 1), -1, jnp.int32),
                self.adj_pts, self.spill,
                metric_name=self.metric.name, prune_budget=budget,
                inline_words=self.inline_words,
            )

    # -- the chunk insert ------------------------------------------------------
    def _insert_chunk(self, chunk: np.ndarray, level: int | None = None):
        """Write + insert a contiguous chunk (sequential path: chunks of 1,
        per-point level draw — hnsw.rs:183-244)."""
        c = chunk.shape[0]
        if self.n + c > self.opts.size:
            from .nsw import NSWBuilder

            NSWBuilder._grow_capacity(self, self.n + c)
        first = self.ep is None
        n0 = self.n
        self.points = _build.write_points(
            self.points, jnp.asarray(chunk), jnp.int32(n0)
        )
        self.n += c
        base_ids = n0 + np.arange(c, dtype=np.int32)

        if first:
            # first point pinned at the current top level (= base, since no
            # levels exist yet) and becomes the entry point (hnsw.rs:185-190)
            self.ep = int(base_ids[0])
            chunk = chunk[1:]
            base_ids = base_ids[1:]
            c -= 1
            if c == 0:
                return

        if level is None:
            level = self._random_level()
        self._insert_registered(chunk, base_ids, level)

    def _insert_registered(self, chunk: np.ndarray, base_ids: np.ndarray,
                           level: int, defer_base: bool = False):
        """Insert already-written points (ids = their base rows) at the
        given level. With ``defer_base`` the final base-layer insert is NOT
        applied; instead (chunk, base_ids, eps) of the real rows is
        returned so grouped builds can merge it into one scanned base
        dispatch (every base chunk_step donates the multi-GB graph +
        inline buffers — one merged dispatch per group instead of one per
        level group).

        Shapes are bucketed up-front (pow2, floor 256): per-level group
        sizes are random, and every novel shape costs a fresh
        compile. Padding rows carry base_id -1 and are
        masked out of every mutation; level slots they scribble on are
        overwritten by the next real group.
        """
        c = chunk.shape[0]
        if c == 0:
            return
        # Bucket floor 8 even for single-point groups: one small program
        # shape instead of a separate cp=1/S=1 chunk_step compile. Padding
        # rows carry base_id -1 and are masked out of every mutation.
        cpad = max(256, 1 << (c - 1).bit_length()) if c > 1 else 8
        if cpad > c:
            chunk = _pad_rows(np.asarray(chunk), cpad)
            base_ids = np.concatenate(
                [base_ids, np.full((cpad - c,), -1, np.int32)]
            ).astype(np.int32)

        # Snapshot the pre-chunk hierarchy: this chunk's descent and inserts
        # must start from the OLD entry point / layers. (The reference
        # updates ep first and accidentally recovers connectivity through
        # its wrong-index-space entry points, hnsw.rs:207-232; with correct
        # down-pointer chaining we must use the old ep explicitly.)
        L_old = len(self.levels)
        ep_old = self.ep

        # create missing levels; remember to re-point ep (hnsw.rs:67-71,89-92)
        new_ep = False
        while len(self.levels) < level:
            l = len(self.levels)
            self.levels.append(_make_level(self._level_capacity(l), self.opts.max_connections))
            self.level_ns.append(0)
            new_ep = True

        cpad = chunk.shape[0]

        # add chunk slots to levels[0..level) — node registration before any
        # search, like hnsw.rs:73-87 (padding rows scribble past level_ns
        # and are overwritten by the next group)
        slots = []  # local id arrays per level occupied (padded length)
        for l in range(level):
            nl = self.level_ns[l]
            self._grow_level(l, nl + cpad)
            lv = self.levels[l]
            loc = nl + np.arange(cpad, dtype=np.int32)
            below = base_ids if l == 0 else slots[l - 1]
            self.levels[l] = Level(
                node_ids=lv.node_ids.at[loc].set(jnp.asarray(base_ids)),
                down=lv.down.at[loc].set(jnp.asarray(below)),
                graph=lv.graph,
            )
            self.level_ns[l] = nl + c
            slots.append(loc)

        if new_ep:
            self.ep = int(slots[-1][0])

        # -- entry points: matmul sampled entry for level-0 points (the vast
        #    majority) skips the descent entirely; points occupying upper
        #    levels keep the greedy descent chain (hnsw.rs:94-108)
        n_before = int(base_ids[0])
        if (
            level == 0
            and self.opts.entry_sample > 0
            and n_before > self.opts.entry_sample
        ):
            # eps_j=None: the sampled entry fuses into the chunk_step
            self._insert_graph(chunk, base_ids, None, n_valid=c)
            return

        eps_j = jnp.full((cpad,), ep_old, jnp.int32)
        for l in range(L_old - 1, level - 1, -1):
            eps_j = self._descend_level(l, chunk, eps_j, c)

        # -- insert top->down through occupied levels (hnsw.rs:111-139).
        #    Brand-new layers (l >= L_old) contain only this chunk: enter at
        #    the chunk's first slot (the star the reference's parallel build
        #    also forms, hnsw.rs:89-108) and keep the old-layer entry chain
        #    untouched.
        for l in range(level - 1, -1, -1):
            if l >= L_old:
                entry = jnp.full((cpad,), int(slots[l][0]), jnp.int32)
                self._insert_level(l, chunk, slots[l], entry, c)
            else:
                eps_j = self._insert_level(l, chunk, slots[l], eps_j, c)

        # -- base layer (hnsw.rs:142-167)
        if defer_base:
            # real rows are a prefix (padding carries base_id -1)
            return (
                np.asarray(chunk)[:c],
                np.asarray(base_ids)[:c],
                np.asarray(eps_j)[:c],
            )
        self._insert_graph(chunk, base_ids, eps_j, n_valid=c)

    # -- helpers ---------------------------------------------------------------
    # chunk arrays arrive bucket-padded; n_valid is the real row count.

    def _descend_level(self, l: int, chunk: np.ndarray, eps_j, n_valid: int):
        """One dispatch per level (_build.level_descend_step)."""
        lv = self.levels[l]
        cpad = chunk.shape[0]
        S = 1 if cpad == 1 else min(self.opts.batch_size, cpad)
        return _build.level_descend_step(
            self.points,
            lv.node_ids,
            lv.graph.adj,
            lv.down,
            jnp.asarray(np.asarray(chunk)),
            eps_j,
            jnp.int32(n_valid),
            S=S,
            metric_name=self.metric.name,
            expand=self.opts.expand,
        )

    def _insert_level(self, l: int, chunk, loc: np.ndarray, eps_j, n_valid):
        """Whole level-group insert in ONE dispatch (_build.level_chunk_step:
        search windows + self-link filter + mutation + down-chaining) — the
        eager per-window loop this replaces was the builder's last
        dispatch-storm stall."""
        lv = self.levels[l]
        cpad = chunk.shape[0]
        new_ids = loc.astype(np.int32).copy()
        new_ids[n_valid:] = -1
        S = 1 if cpad == 1 else min(self.opts.batch_size, cpad)
        g, next_eps, dropped = _build.level_chunk_step(
            self.points,
            lv.node_ids,
            lv.graph,
            lv.down,
            jnp.asarray(np.asarray(chunk)),
            jnp.asarray(new_ids),
            eps_j,
            jnp.int32(n_valid),
            S=S,
            efc=self.opts.ef_construction,
            m=self.opts.connections,
            metric_name=self.metric.name,
            expand=self.opts.expand,
            prune_budget=min(lv.graph.adj.shape[0],
                             max(self.opts.prune_budget, cpad)),
        )
        self.edge_drops.append(dropped)
        self.levels[l] = Level(lv.node_ids, lv.down, g)
        return next_eps

    def _insert_graph(self, chunk, base_ids: np.ndarray, eps_j, n_valid: int):
        """Base-layer insert in ONE device dispatch (_build.chunk_step; see
        NSWBuilder._insert_chunk for the rationale). Points were already
        written by extend_batched, so do_write=False.
        ``chunk``/``base_ids``/``eps_j`` arrive bucket-padded."""
        cp = chunk.shape[0]
        S = 1 if cp == 1 else min(self.opts.batch_size, cp)
        qj = jnp.asarray(np.asarray(chunk))
        new_ids = np.asarray(base_ids).astype(np.int32).copy()
        new_ids[n_valid:] = -1
        # population bound for sampled entry = rows before this chunk
        n_before = int(new_ids[0]) if n_valid > 0 else 0
        use_entry = eps_j is None
        # HNSW_SPLIT_CHUNK=1: two dispatches (search, mutation), each
        # compiling about half the program (_build.chunk_step_split)
        step_fn = (_build.chunk_step_split
                   if os.environ.get("HNSW_SPLIT_CHUNK") == "1"
                   else _build.chunk_step)
        (self.points, self.base, self.adj_pts, self.spill,
         dropped) = step_fn(
            self.points,
            self._node_map,
            self.base,
            self.adj_pts,
            self.spill,
            qj,
            jnp.asarray(new_ids),
            jnp.int32(n_before),
            jnp.int32(0) if eps_j is None else eps_j,
            jnp.int32(n_valid),
            S=S,
            efc=self.opts.ef_construction,
            m=self.opts.connections,
            metric_name=self.metric.name,
            expand=self.opts.expand,
            # scale the prune budget with the chunk (see NSWBuilder)
            prune_budget=min(self.opts.size,
                             max(self.opts.prune_budget, cp)),
            entry_sample=self.opts.entry_sample,
            use_entry=use_entry,
            do_write=False,
            inline_words=self.inline_words,
        )
        self.edge_drops.append(dropped)
        if self.adj_pts is not None and self.adj_pts.nbytes > 1 << 30:
            # throttle queue-ahead dispatch (see NSWBuilder._insert_chunk)
            np.asarray(self.base.deg[:1])

    def _insert_base_scanned(self, chunk: np.ndarray, base_ids: np.ndarray,
                             eps: np.ndarray, c: int):
        """A whole group's base-layer inserts in ONE dispatch
        (_build.chunk_steps_scanned_prewritten): the scanned analogue of
        ``_insert_graph``. Points were written by extend_batched; the id
        vector is passed explicitly (id order, one row per group point).
        ``eps`` rows >= 0 carry the descent-chained entries of the
        deferred upper-level points; -1 rows (the level-0 majority) use
        the matmul sampled entry, whose population bound is the group start
        for every sub-chunk (conservative: later sub-chunks don't sample
        the group's own rows — a 1-in-entry_sample effect)."""
        n_all = chunk.shape[0]
        # the level partition + deferred parts cover every point of the
        # G-chunk window exactly once — a partition bug must fail loudly,
        # not get silently padded over
        if n_all % c != 0:
            raise AssertionError(
                f"scanned base insert expects whole sub-chunks: {n_all} "
                f"rows vs sub-chunk size {c}"
            )
        n0 = int(base_ids[0])
        Gs = n_all // c
        S = min(self.opts.batch_size, c)
        (self.base, self.adj_pts, self.spill,
         dropped) = _build.chunk_steps_scanned_prewritten(
            self.points,
            self._node_map,
            self.base,
            self.adj_pts,
            self.spill,
            jnp.asarray(np.asarray(chunk)),
            jnp.asarray(np.asarray(base_ids, np.int32)),
            jnp.asarray(np.full((Gs,), n0, np.int32)),
            jnp.asarray(np.asarray(eps, np.int32)),
            G=Gs,
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
        self.edge_drops.append(dropped)
        if self.adj_pts is not None and self.adj_pts.nbytes > 1 << 30:
            # throttle queue-ahead dispatch (see NSWBuilder._insert_chunk)
            np.asarray(self.base.deg[:1])
