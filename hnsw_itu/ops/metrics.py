"""Distance metrics, array-native.

The reference defines distances through the ``Point`` trait
(``Point::distance -> usize``, reference/src/index/mod.rs:45-47) with two
concrete instances: 1024-bit Hamming on packed sketches
(reference/cli/src/sketch.rs:19-29) and integer squared-L2
(reference/examples/main.rs:7-11).

Here a metric is a small object exposing batched, fixed-shape array kernels:

* ``one_to_many(q, pts) -> [C]`` — one query against C gathered points; this
  is the shape the beam-search frontier expansion needs (elementwise path).
* ``pairwise(A, B) -> [M, N]`` — dense distance blocks for brute-force scans
  and the select-neighbors diversity heuristic. For large blocks the Hamming
  metric routes through a matmul via the bit-unpack + matmul identity
  ``ham(a,b) = popcnt(a) + popcnt(b) - 2 * <bits_a, bits_b>`` and the L2
  metrics via ``|a-b|^2 = |a|^2 + |b|^2 - 2ab``.

All distances are integer-valued (like the reference's ``usize``) and stored
as int32; float metrics use float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

# 1024-bit sketches = 32 packed uint32 words (the reference packs them as
# [u64; 16], cli/src/sketch.rs:7-9; uint32 is the natural device word).
SKETCH_WORDS_U32 = 32
SKETCH_BITS = 1024

INT32_INF = jnp.iinfo(jnp.int32).max


def _popcount_sum(x: jax.Array) -> jax.Array:
    """Sum of per-word popcounts over the trailing axis -> int32."""
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def unpack_bits_u32(packed: jax.Array) -> jax.Array:
    """uint32[..., W] -> uint8[..., W*32] bit expansion (bit order is
    consistent between both operands, which is all Hamming needs)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).astype(jnp.uint8)


def pack_bits_u32(bits) -> jax.Array:
    """uint8/bool[..., W*32] -> uint32[..., W]; inverse of unpack_bits_u32."""
    bits = jnp.asarray(bits)
    w = bits.shape[-1] // 32
    bits = bits.reshape(*bits.shape[:-1], w, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)


@dataclass(frozen=True)
class Metric:
    """A batched distance kernel family. ``dist_dtype`` is the dtype of
    returned distances; ``inf`` is the +infinity sentinel of that dtype."""

    name: str

    @property
    def dist_dtype(self):
        return jnp.int32

    @property
    def inf(self):
        return INT32_INF

    def max_distance(self, q) -> int | None:
        """Static upper bound on distances for this query shape, or None if
        unbounded (enables packed (distance, id) sort keys)."""
        return None

    def one_to_many(self, q: jax.Array, pts: jax.Array) -> jax.Array:
        raise NotImplementedError

    def pairwise(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """Small/medium dense blocks (elementwise path)."""
        return jax.vmap(lambda q: self.one_to_many(q, b))(a)

    def pairwise_mxu(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """Large dense blocks routed through a matmul. Defaults to the elementwise
        path; overridden where a matmul formulation exists."""
        return self.pairwise(a, b)


class Hamming(Metric):
    """XOR + popcount over packed uint32 words.

    Parity target: cli/src/sketch.rs:19-29 (scalar fold) and the AVX2 variant
    in cli/benches/distance/bench.rs:59-88. On the device XLA fuses the
    XOR / popcount elementwise and a bit-unpacked matmul handles dense
    blocks.
    """

    def __init__(self):
        super().__init__(name="hamming")

    def max_distance(self, q) -> int:
        return int(q.shape[-1]) * 32

    def one_to_many(self, q, pts):
        return _popcount_sum(jnp.bitwise_xor(pts, q))

    def pairwise(self, a, b):
        # [M,1,W] ^ [1,N,W] -> popcount-sum. Fine for M*N up to ~1e6.
        return _popcount_sum(a[:, None, :] ^ b[None, :, :])

    def pairwise_mxu(self, a, b):
        # ham(a,b) = pop(a) + pop(b) - 2 * <bits_a, bits_b>
        # Products are 0/1 and the sum <= 1024, exactly representable in f32
        # accumulation, so this is exact.
        pa = _popcount_sum(a)  # [M]
        pb = _popcount_sum(b)  # [N]
        ba = unpack_bits_u32(a).astype(jnp.bfloat16)
        bb = unpack_bits_u32(b).astype(jnp.bfloat16)
        dots = jax.lax.dot_general(
            ba, bb, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )
        return (pa[:, None] + pb[None, :] - 2 * dots.astype(jnp.int32)).astype(
            jnp.int32
        )


class SquaredL2Int(Metric):
    """Integer squared L2 — the generic-``Point`` path the reference
    demonstrates with Point3D (examples/main.rs:7-11) and the |a-b| i32
    distance used by its unit tests (src/index/nsw.rs:360-364)."""

    def __init__(self):
        super().__init__(name="l2int")

    def one_to_many(self, q, pts):
        d = pts.astype(jnp.int32) - q.astype(jnp.int32)
        return jnp.sum(d * d, axis=-1)

    def pairwise(self, a, b):
        d = a[:, None, :].astype(jnp.int32) - b[None, :, :].astype(jnp.int32)
        return jnp.sum(d * d, axis=-1)


class SquaredL2(Metric):
    """float32 squared L2 (matmul-friendly via the norm expansion)."""

    def __init__(self):
        super().__init__(name="l2")

    @property
    def dist_dtype(self):
        return jnp.float32

    @property
    def inf(self):
        return jnp.float32(jnp.inf)

    def one_to_many(self, q, pts):
        d = pts - q
        return jnp.sum(d * d, axis=-1)

    def pairwise(self, a, b):
        d = a[:, None, :] - b[None, :, :]
        return jnp.sum(d * d, axis=-1)

    def pairwise_mxu(self, a, b):
        na = jnp.sum(a * a, axis=-1)
        nb = jnp.sum(b * b, axis=-1)
        # HIGHEST: a float32 product may otherwise run in TF32 (~3 decimal
        # digits), and this feeds the exact oracle and neighbour selection
        ab = jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return jnp.maximum(na[:, None] + nb[None, :] - 2.0 * ab, 0.0)


HAMMING = Hamming()
L2INT = SquaredL2Int()
L2 = SquaredL2()

_REGISTRY = {m.name: m for m in (HAMMING, L2INT, L2)}
# names that have been RESOLVED since process start: a compiled executable
# can only bake in a metric that some trace looked up here, so an
# overwrite of a never-resolved name needs no cache clear
_RESOLVED: set = set()


def get_metric(name: str) -> Metric:
    try:
        m = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    _RESOLVED.add(name)
    return m


def register_metric(metric: Metric, *, overwrite: bool = False) -> Metric:
    """Register a user metric under ``metric.name`` — the public extension
    point matching the reference's generic ``Point`` trait (any user type
    with an integer ``distance``, src/index/mod.rs:45-47; demonstrated by
    Point3D, examples/main.rs:7-11).

    A metric is a ``Metric`` subclass providing at least ``one_to_many``
    (the beam-search expansion shape); ``pairwise``/``pairwise_mxu`` have
    working defaults, and ``max_distance`` may return a static bound to
    enable packed (distance, id) sort keys. After registration the name
    works everywhere a built-in does: builders (``NSWBuilder(opts,
    metric="myname")``), ``Bruteforce``, serialization round trips
    (utils/serialize.py stores the metric name), and the jitted query
    steps (which re-resolve metrics by name through this registry).

    See examples/custom_metric.py for an end-to-end custom integer metric.
    Returns the metric for chaining.
    """
    if not isinstance(metric, Metric):
        raise TypeError("register_metric expects a Metric instance")
    if not metric.name or not isinstance(metric.name, str):
        raise ValueError("metric.name must be a non-empty string")
    if metric.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"metric {metric.name!r} already registered "
            "(pass overwrite=True to replace)"
        )
    if overwrite and metric.name in _RESOLVED:
        # the jitted query/build steps cache executables keyed by the
        # static metric NAME — a same-shape call after a replacement
        # would silently keep computing the OLD metric's distances. An
        # executable can only bake in a metric some trace RESOLVED via
        # get_metric, so the (process-wide, expensive in long sessions)
        # clear fires only for names actually seen by a trace — the
        # common overwrite-at-setup of a fresh name costs nothing. This
        # also covers pop-then-register through the private registry:
        # _RESOLVED is never cleared by removal.
        import jax

        jax.clear_caches()
        _RESOLVED.discard(metric.name)
    _REGISTRY[metric.name] = metric
    return metric


@functools.lru_cache(maxsize=None)
def _check_words(w):
    if w != SKETCH_WORDS_U32:
        raise ValueError(f"sketches must have {SKETCH_WORDS_U32} uint32 words, got {w}")


def sketches_from_u64(rows) -> jax.Array:
    """[N,16] uint64 HDF5 rows -> [N,32] packed uint32 device sketches.

    Mirrors From<Array1<u64>> for Sketch (cli/src/sketch.rs:31-39). The u64 ->
    2xu32 split keeps total popcounts identical, so Hamming distances match
    the reference exactly.
    """
    import numpy as np

    rows = np.asarray(rows, dtype=np.uint64)
    lo = (rows & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (rows >> np.uint64(32)).astype(np.uint32)
    out = np.empty((*rows.shape[:-1], rows.shape[-1] * 2), dtype=np.uint32)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    _check_words(out.shape[-1])
    return out


def sketches_to_u64(packed) -> "np.ndarray":
    """Inverse of sketches_from_u64 (for write_row parity)."""
    import numpy as np

    packed = np.asarray(packed, dtype=np.uint32)
    lo = packed[..., 0::2].astype(np.uint64)
    hi = packed[..., 1::2].astype(np.uint64)
    return lo | (hi << np.uint64(32))
