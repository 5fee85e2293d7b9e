"""Exact k-NN by tiled scan — ground-truth oracle.

Parity target: ``Bruteforce`` (reference/src/index/bruteforce.rs:9-70):
map every point to a Distance, stream through MinK. Device redesign: the scan
is a ``lax.fori_loop`` over point tiles; each tile computes a dense
query-tile x point-tile distance block as a matmul (bit-unpacked Hamming
matmul / L2 norm expansion) and folds it into a running top-k via two-key
sort merge. ``ef`` is ignored, like the reference (bruteforce.rs:38).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.metrics import Metric, get_metric, unpack_bits_u32
from ..ops.topk import merge_min_k
from .base import ID_INF, KnnResult, device_memory_limit

# headroom kept beside the bit table: the queries' tiles, the running top-k
# and the runtime's own reservation
_MARGIN_BYTES = 1.6e9
# bit-table budget where the backend reports no allocator limit (the CPU):
# about 2M 1024-bit rows
_UNLIMITED_TABLE_BYTES = 4.1e9


def _bits_table_fits(n_rows: int, words: int, point_bytes: int) -> bool:
    """Is the bit-unpacked bf16 point table (n x words*32 x 2B) worth
    building? Precomputing it removes the per-tile unpack relayout that
    otherwise dominates the scan. Where the device reports its allocator
    limit, the table + the points + a margin must fit it; elsewhere the
    fixed ``_UNLIMITED_TABLE_BYTES`` budget decides."""
    need = n_rows * words * 32 * 2
    limit = device_memory_limit()
    if limit is None:
        return need <= _UNLIMITED_TABLE_BYTES
    return need + point_bytes + _MARGIN_BYTES <= limit


@functools.partial(jax.jit, static_argnames=("tile",))
def _unpack_table(points, *, tile):
    n = points.shape[0]

    def body(i, out):
        start = i * tile
        p = jax.lax.dynamic_slice_in_dim(points, start, tile, 0)
        return jax.lax.dynamic_update_slice(
            out, unpack_bits_u32(p).astype(jnp.bfloat16), (start, 0)
        )

    bits = jnp.zeros((n, points.shape[1] * 32), jnp.bfloat16)
    return jax.lax.fori_loop(0, n // tile, body, bits)


@functools.partial(
    jax.jit, static_argnames=("k", "tile", "n_tiles", "lane_bits")
)
def _scan_knns_bits(q_bits, pq, pts_bits, pp, n, *, k, tile, n_tiles,
                    lane_bits):
    """Hamming scan over a PRE-UNPACKED bf16 bit table:
    d = pop(q) + pop(p) - 2 <bits_q, bits_p> (exact in f32), tile top-k by
    packed-key min-extraction."""
    B = q_bits.shape[0]
    inf = np.iinfo(np.int32).max

    def body(t, carry):
        best_d, best_i = carry
        start = t * tile
        pb = jax.lax.dynamic_slice_in_dim(pts_bits, start, tile, 0)
        pp_t = jax.lax.dynamic_slice_in_dim(pp, start, tile, 0)
        dots = jax.lax.dot_general(
            q_bits, pb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        d = pq[:, None] + pp_t[None, :] - 2 * dots.astype(jnp.int32)
        ids = start + jnp.arange(tile, dtype=jnp.int32)
        key = (d << lane_bits) | jnp.arange(tile, dtype=jnp.int32)
        key = jnp.where((ids < n)[None, :], key, jnp.int32(2**31 - 1))
        kk = min(k, tile)

        def extract(j, c):
            key, td, ti = c
            m = jnp.min(key, axis=1)
            td = td.at[:, j].set(
                jnp.where(m < 2**31 - 1, m >> lane_bits, inf)
            )
            ti = ti.at[:, j].set(
                jnp.where(m < 2**31 - 1,
                          start + (m & ((1 << lane_bits) - 1)), ID_INF)
            )
            return jnp.where(key == m[:, None], jnp.int32(2**31 - 1),
                             key), td, ti

        _, t_d, t_i = jax.lax.fori_loop(
            0, kk, extract,
            (key, jnp.full((B, kk), inf, jnp.int32),
             jnp.full((B, kk), ID_INF, jnp.int32)),
        )
        return merge_min_k(best_d, best_i, t_d, t_i, k)

    init = (jnp.full((B, k), inf, jnp.int32),
            jnp.full((B, k), ID_INF, jnp.int32))
    return jax.lax.fori_loop(0, n_tiles, body, init)


def _pad_rows(x: np.ndarray, to: int):
    if x.shape[0] == to:
        return x
    pad = np.zeros((to - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0)


@functools.partial(
    jax.jit, static_argnames=("k", "metric_name", "tile", "n_tiles")
)
def _scan_knns(queries, points, n, *, k, metric_name, tile, n_tiles):
    metric = get_metric(metric_name)
    B = queries.shape[0]
    inf = metric.inf
    # bounded integer metrics pack (d, lane) into one int32 key and extract
    # the tile top-k by k min-reductions — lax.top_k lowers to a FULL
    # bitonic sort of the tile)
    max_d = metric.max_distance(queries[0])
    lane_bits = max(1, (tile - 1).bit_length())
    packed = (
        max_d is not None
        and lane_bits + (int(max_d) + 1).bit_length() <= 31
    )

    def body(t, carry):
        best_d, best_i = carry
        start = t * tile
        pts = jax.lax.dynamic_slice_in_dim(points, start, tile, axis=0)
        d = metric.pairwise_mxu(queries, pts)  # [B, tile]
        ids = start + jnp.arange(tile, dtype=jnp.int32)
        valid = ids < n
        if packed:
            key = (d.astype(jnp.int32) << lane_bits) | jnp.arange(
                tile, dtype=jnp.int32
            )
            key = jnp.where(valid[None, :], key, jnp.int32(2**31 - 1))
            kk = min(k, tile)

            def extract(j, c):
                key, td, ti = c
                m = jnp.min(key, axis=1)  # [B]
                td = td.at[:, j].set(
                    jnp.where(m < 2**31 - 1, m >> lane_bits, inf)
                )
                ti = ti.at[:, j].set(
                    jnp.where(
                        m < 2**31 - 1,
                        start + (m & ((1 << lane_bits) - 1)),
                        ID_INF,
                    )
                )
                return jnp.where(key == m[:, None], jnp.int32(2**31 - 1),
                                 key), td, ti

            _, t_d, t_i = jax.lax.fori_loop(
                0, kk, extract,
                (key, jnp.full((B, kk), inf, metric.dist_dtype),
                 jnp.full((B, kk), ID_INF, jnp.int32)),
            )
            return merge_min_k(best_d, best_i, t_d, t_i, k)
        d = jnp.where(valid[None, :], d, inf)
        idv = jnp.where(valid, ids, ID_INF)
        # tile-local top-k first (cheap), then a small two-key merge — a
        # full [B, tile+k] sort would be a giant bitonic network
        neg_td, t_pos = jax.lax.top_k(-d, min(k, tile))
        t_i = jnp.broadcast_to(idv, (B, tile))[
            jnp.arange(B)[:, None], t_pos
        ]
        return merge_min_k(best_d, best_i, -neg_td, t_i, k)

    init = (
        jnp.full((B, k), inf, metric.dist_dtype),
        jnp.full((B, k), ID_INF, jnp.int32),
    )
    best_d, best_i = jax.lax.fori_loop(0, n_tiles, body, init)
    return best_d, best_i


class Bruteforce:
    """Exact index; is its own builder (bruteforce.rs:25-35)."""

    def __init__(self, metric: Metric | str = "hamming", tile: int = 8192):
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        self.tile = tile
        self._chunks: list[np.ndarray] = []
        self._points = None
        self._n = 0

    # -- IndexBuilder parity -------------------------------------------------
    def add(self, point) -> None:
        self.extend(np.asarray(point)[None])

    def extend(self, points) -> None:
        pts = np.asarray(points)
        self._chunks.append(pts)
        self._n += pts.shape[0]
        self._points = None

    def build(self) -> "Bruteforce":
        self._materialize()
        return self

    # -- Index parity ----------------------------------------------------------
    def size(self) -> int:
        return self._n

    def _materialize(self):
        if self._points is None:
            if not self._chunks:
                raise ValueError("empty index")
            all_pts = np.concatenate(self._chunks, axis=0)
            self._chunks = [all_pts]
            tile = min(self.tile, max(256, 1 << (self._n - 1).bit_length()))
            self._tile_eff = min(tile, self.tile)
            cap = -(-self._n // self._tile_eff) * self._tile_eff
            self._points = jnp.asarray(_pad_rows(all_pts, cap))
        return self._points

    def search(self, query, k: int, ef: int = 0) -> KnnResult:
        r = self.knns(np.asarray(query)[None], k, ef)
        return KnnResult(r.dists[0], r.ids[0])

    def knns(self, queries, k: int, ef: int = 0, batch: int = 1024) -> KnnResult:
        del ef  # ignored, like the reference (bruteforce.rs:38)
        qs = np.asarray(queries)
        words = int(np.prod(self._chunks[0].shape[1:])) if self._chunks else 0
        big = not _bits_table_fits(self._n, words, self._n * words * 4)
        use_bits = self.metric.name == "hamming" and not big
        # past the bit-table budget the device would unpack every tile per
        # batch (a relayout per tile — hours at 10M); the blocked native
        # host scan is exact and compute-bound there
        from .. import native

        if (
            big
            and self.metric.name in native.METRIC_CODE
            and self._n > 0
            and native.available()
        ):
            if len(self._chunks) > 1:
                self._chunks = [np.concatenate(self._chunks, axis=0)]
            d, i = native.host_bruteforce(
                np.ascontiguousarray(self._chunks[0][: self._n]),
                self.metric.name, qs, k,
            )
            return KnnResult(jnp.asarray(d), jnp.asarray(i))
        pts = self._materialize()
        nq = qs.shape[0]
        n_tiles = pts.shape[0] // self._tile_eff
        bits = pops = None
        if use_bits:
            # call-local (2 bytes/bit): freed before query tables build
            bits = _unpack_table(pts, tile=self._tile_eff)
            pops = jnp.sum(
                jax.lax.population_count(pts).astype(jnp.int32), axis=-1
            )
        out_d, out_i = [], []
        for s in range(0, nq, batch):
            q = qs[s : s + batch]
            b = q.shape[0]
            qb = _pad_rows(q, min(batch, max(b, 8)))
            if use_bits:
                qj = jnp.asarray(qb)
                d, i = _scan_knns_bits(
                    unpack_bits_u32(qj).astype(jnp.bfloat16),
                    jnp.sum(jax.lax.population_count(qj).astype(jnp.int32),
                            axis=-1),
                    bits,
                    pops,
                    jnp.int32(self._n),
                    k=k,
                    tile=self._tile_eff,
                    n_tiles=n_tiles,
                    lane_bits=max(1, (self._tile_eff - 1).bit_length()),
                )
            else:
                d, i = _scan_knns(
                    jnp.asarray(qb),
                    pts,
                    jnp.int32(self._n),
                    k=k,
                    metric_name=self.metric.name,
                    tile=self._tile_eff,
                    n_tiles=n_tiles,
                )
            out_d.append(np.asarray(d)[:b])
            out_i.append(np.asarray(i)[:b])
        if bits is not None:
            bits.delete()
        return KnnResult(
            jnp.asarray(np.concatenate(out_d)), jnp.asarray(np.concatenate(out_i))
        )
