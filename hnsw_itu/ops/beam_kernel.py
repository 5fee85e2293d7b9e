"""The CUDA beam-search kernel (native/beam_search.cu) as a JAX operation.

One warp per query keeps the beam and its expanded flags in shared memory
for the whole search; each expansion reads the expanded node's adjacency row
and its inline neighbour-sketch row (``adj_pts``, the table the XLA inline
path reads too). Results are those of ``ops/search.py _beam_search_packed``
(dedup="beam", expand=1): the same keys, visited and step counts.

Keys pack (distance, id) into one int32 as ``(d << id_bits) | id``.
Distances are clamped to ``key_clamp(id_bits, max_d)``, so the kernel can
serve any index whose clamp sits past half the metric's range
(``kernel_eligible``); below 2^20 nodes of 1024-bit sketches the clamp is
the metric's own bound and nothing is clamped.

The library is built from the committed source by ``make -C native cuda``
at first use, into ``native/build/`` (git-ignored). It needs ``nvcc`` and
runs only on a CUDA device; there is no interpret mode, so the CPU tests
cover the wrapper (``prepare``, ``decode``, ``kernel_eligible``) and the
plain reference, and ``chip_smoke.py`` compares the kernel with the
reference on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np

MAX_SLOTS = 128  # widest beam and adjacency row one warp holds
WORDS = 32  # sketch width (uint32 words) the kernel is built for: 1024 bits
TARGET = "hnsw_beam_search"

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LOCK = threading.Lock()
_STATE: dict = {}


def key_clamp(id_bits: int, max_d: int) -> int:
    """Largest distance a packed key can carry: min(max_d, 2^(31-id_bits) - 2).
    Distances past it are clamped, which sacrifices their order only."""
    return min(max_d, (1 << (31 - id_bits)) - 2)


def id_bits_for(cap: int) -> int:
    return max(1, (cap - 1).bit_length())


def kernel_eligible(metric_name: str, cap: int, W: int, words: int,
                    ef: int, tie_bits: int = 0) -> bool:
    """Shapes the kernel serves: 1024-bit Hamming sketches, rows
    and beams of at most 128, no tie re-encoding, and a key clamp past
    half the metric's range (typical entry distances on 1024-bit sketches
    are ~512, so ordering stays intact where the beam lives)."""
    return (
        metric_name == "hamming"
        and words == WORDS
        and 1 <= W <= MAX_SLOTS
        and 1 <= ef <= MAX_SLOTS
        and tie_bits == 0
        and key_clamp(id_bits_for(cap), words * 32) >= words * 16
    )


def _load():
    """Build (make is a no-op when fresh) and register the FFI target, once
    per process: a failure is kept too, so ``make`` never runs again."""
    with _LOCK:
        if "lib" not in _STATE:
            _STATE["lib"] = None
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "cuda",
                 f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
                check=True, capture_output=True, text=True,
            )
            lib = ctypes.CDLL(os.path.join(_NATIVE_DIR, "build",
                                           "libhnsw_cuda.so"))
            jax.ffi.register_ffi_target(
                TARGET, jax.ffi.pycapsule(lib.HnswBeamSearch),
                platform="CUDA",
            )
            _STATE["lib"] = lib
        if _STATE["lib"] is None:
            raise OSError("the CUDA beam kernel failed to build or load "
                          "earlier in this process")
        return _STATE["lib"]


def available() -> bool:
    """True when the default device is a CUDA GPU and the kernel library
    builds and loads. The first call builds it (callers that time queries
    call this first, so the compile stays out of the first query). On a
    GPU where it does not build, it warns (the first warning carries
    make's output), and the planner serves queries with the XLA loop."""
    if jax.default_backend() != "gpu":
        return False
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", "") or exc
        warnings.warn(f"CUDA beam kernel unavailable, queries use the "
                      f"XLA loop: {detail}", stacklevel=2)
        return False


def prepare(d0, eps, *, cap: int, words: int):
    """(init keys, id_bits, max_d) for entry distances ``d0`` and entry ids
    ``eps``: the packed key of each query's entry point."""
    id_bits = id_bits_for(cap)
    max_d = key_clamp(id_bits, words * 32)
    init = (jnp.minimum(d0.astype(jnp.int32), max_d) << id_bits) | eps
    return init.astype(jnp.int32), id_bits, max_d


def decode(keys, *, id_bits: int, max_d: int, inf, id_inf):
    """Packed keys -> (dists, ids); empty slots -> (inf, id_inf)."""
    valid = keys < ((max_d + 1) << id_bits)
    d = jnp.where(valid, keys >> id_bits, inf)
    i = jnp.where(valid, keys & ((1 << id_bits) - 1), id_inf)
    return d, i


def beam_search(adj, rows, queries, init_keys, *, ef: int, id_bits: int,
                max_d: int, max_steps: int):
    """Run the kernel: returns (keys int32[B, ef] ascending, visited
    int32[B], steps int32[B]). ``rows`` is the inline table
    uint32[cap, W*words]; ``queries`` uint32[B, words]."""
    _load()
    B = queries.shape[0]
    q = queries.reshape(B, -1).astype(jnp.uint32)
    out = (
        jax.ShapeDtypeStruct((B, ef), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32),
    )
    return jax.ffi.ffi_call(TARGET, out)(
        q, init_keys.astype(jnp.int32), adj, rows.astype(jnp.uint32),
        ef=np.int32(ef), id_bits=np.int32(id_bits), max_d=np.int32(max_d),
        max_steps=np.int32(max_steps),
    )
