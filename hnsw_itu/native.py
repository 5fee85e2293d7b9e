"""ctypes bindings for the native host runtime (native/hnsw_host.cpp).

The shared library is compiled on first use (g++ is part of the toolchain;
pybind11 is not available in this image, hence the plain C ABI + ctypes).
Exposes:

* ``host_build``      — exact-reference-semantics sequential inserts into the
                        padded adjacency arrays (the 50k-warmup engine,
                        nsw.rs:234)
* ``host_knns``       — multithreaded batch search (rayon par_iter analogue)
* ``host_bruteforce`` — exact scan oracle
* ``hamming``         — scalar distance golden hook
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
# override hook: point at an instrumented build (e.g. -fsanitize=address)
# without touching the checked-in Makefile artifact
_SO = os.environ.get(
    "HNSW_NATIVE_SO", os.path.join(_NATIVE_DIR, "libhnsw_host.so")
)

METRIC_CODE = {"hamming": 0, "l2int": 1}


def _build_lib():
    subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
        text=True,
    )


def available() -> bool:
    try:
        return load() is not None
    except Exception:
        return False


def load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        # always invoke make: the Makefile's hnsw_host.cpp dependency makes
        # this a no-op when the .so is fresh, rebuilds it after source edits,
        # and recompiles for the local CPU (-march=native) on a new machine
        _build_lib()
        lib = ctypes.CDLL(_SO)
        lib.hnsw_host_abi_version.restype = ctypes.c_int32
        if lib.hnsw_host_abi_version() != 3:
            raise RuntimeError("hnsw_host ABI mismatch")
        lib.hnsw_host_hamming.restype = ctypes.c_int32
        lib.hnsw_host_build.restype = ctypes.c_int64
        lib.hnsw_host_build_hnsw.restype = ctypes.c_int64
        lib.hnsw_host_knns.restype = ctypes.c_int64
        lib.hnsw_host_knns_eps.restype = ctypes.c_int64
        lib.hnsw_host_bruteforce.restype = ctypes.c_int64
        _LIB = lib
        return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    lib = load()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    return int(lib.hnsw_host_hamming(_ptr(a), _ptr(b), ctypes.c_int32(a.size)))


def host_build(points: np.ndarray, metric: str, adj: np.ndarray,
               deg: np.ndarray, n0: int, n1: int, m: int, efc: int,
               ep: int) -> int:
    """Insert points [n0, n1) sequentially; mutates adj/deg in place."""
    lib = load()
    assert adj.dtype == np.int32 and adj.flags.c_contiguous
    assert deg.dtype == np.int32 and deg.flags.c_contiguous
    points = np.ascontiguousarray(points)
    r = lib.hnsw_host_build(
        _ptr(points),
        ctypes.c_int32(points.shape[1]),
        ctypes.c_int32(METRIC_CODE[metric]),
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(adj.shape[0]),
        ctypes.c_int32(adj.shape[1]),
        ctypes.c_int64(n0),
        ctypes.c_int64(n1),
        ctypes.c_int32(m),
        ctypes.c_int32(efc),
        ctypes.c_int32(ep),
    )
    if r < 0:
        raise ValueError("hnsw_host_build: bad arguments")
    return int(r)


def host_build_hnsw(points: np.ndarray, metric: str, adj: np.ndarray,
                    deg: np.ndarray, n0: int, n1: int, m: int, efc: int,
                    draws: np.ndarray, level_caps: list[int],
                    lvl_node_ids: np.ndarray, lvl_down: np.ndarray,
                    lvl_adj: np.ndarray, lvl_deg: np.ndarray,
                    level_ns: np.ndarray, ep: int) -> tuple[int, int]:
    """Full-hierarchy sequential inserts of [n0, n1) (hnsw.rs:183-244).
    ``draws`` int32[n1] are pre-drawn per-point levels; level arrays are
    concatenated per-level buffers sized by ``level_caps`` (adj rows have
    the base width). Mutates everything in place; returns (inserted,
    new_ep)."""
    lib = load()
    for a in (adj, deg, draws, lvl_node_ids, lvl_down, lvl_adj, lvl_deg):
        assert a.dtype == np.int32 and a.flags.c_contiguous
    assert level_ns.dtype == np.int64 and level_ns.flags.c_contiguous
    points = np.ascontiguousarray(points)
    caps = np.asarray(level_caps, np.int64)
    ep_io = np.asarray([ep], np.int64)
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    i64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    r = lib.hnsw_host_build_hnsw(
        _ptr(points),
        ctypes.c_int32(points.shape[1]),
        ctypes.c_int32(METRIC_CODE[metric]),
        i32p(adj), i32p(deg),
        ctypes.c_int64(adj.shape[0]),
        ctypes.c_int32(adj.shape[1]),
        ctypes.c_int64(n0),
        ctypes.c_int64(n1),
        ctypes.c_int32(m),
        ctypes.c_int32(efc),
        i32p(draws),
        ctypes.c_int32(len(level_caps)),
        i64p(caps),
        i32p(lvl_node_ids), i32p(lvl_down), i32p(lvl_adj), i32p(lvl_deg),
        i64p(level_ns), i64p(ep_io),
    )
    if r < 0:
        raise ValueError("hnsw_host_build_hnsw: bad arguments")
    return int(r), int(ep_io[0])


def host_knns(points: np.ndarray, metric: str, adj: np.ndarray,
              deg: np.ndarray, n: int, queries: np.ndarray, k: int, ef: int,
              ep: int = 0, threads: int = 0, eps: np.ndarray | None = None):
    """Batch k-NN on the host engine. ``eps`` (optional int32[nq]) gives a
    per-query entry point — the HNSW level-descent hook; else the scalar
    ``ep`` seeds every query."""
    lib = load()
    points = np.ascontiguousarray(points)
    queries = np.ascontiguousarray(queries, points.dtype)
    nq = queries.shape[0]
    out_ids = np.empty((nq, k), np.int32)
    out_dists = np.empty((nq, k), np.int32)
    if eps is not None:
        eps = np.ascontiguousarray(eps, np.int32)
        assert eps.shape == (nq,)
        eps_ptr = eps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    else:
        eps_ptr = None
    r = lib.hnsw_host_knns_eps(
        _ptr(points),
        ctypes.c_int32(points.shape[1]),
        ctypes.c_int32(METRIC_CODE[metric]),
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(adj.shape[0]),
        ctypes.c_int32(adj.shape[1]),
        ctypes.c_int64(n),
        _ptr(queries),
        ctypes.c_int64(nq),
        ctypes.c_int32(k),
        ctypes.c_int32(ef),
        eps_ptr,
        ctypes.c_int32(ep),
        ctypes.c_int32(threads),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if r < 0:
        raise ValueError("hnsw_host_knns: bad arguments")
    return out_dists, out_ids


def host_bruteforce(points: np.ndarray, metric: str, queries: np.ndarray,
                    k: int, threads: int = 0):
    lib = load()
    points = np.ascontiguousarray(points)
    queries = np.ascontiguousarray(queries, points.dtype)
    nq = queries.shape[0]
    out_ids = np.empty((nq, k), np.int32)
    out_dists = np.empty((nq, k), np.int32)
    r = lib.hnsw_host_bruteforce(
        _ptr(points),
        ctypes.c_int32(points.shape[1]),
        ctypes.c_int32(METRIC_CODE[metric]),
        ctypes.c_int64(points.shape[0]),
        _ptr(queries),
        ctypes.c_int64(nq),
        ctypes.c_int32(k),
        ctypes.c_int32(threads),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if r < 0:
        raise ValueError("hnsw_host_bruteforce: bad arguments")
    return out_dists, out_ids
