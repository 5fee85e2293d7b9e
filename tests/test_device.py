"""Device-facing plumbing that runs on any backend: the compile-cache
location, the device memory helper, float32 matmul precision, the query
planner, and the CUDA beam kernel's wrapper (key packing, eligibility,
batch padding). The kernel itself runs only on a CUDA GPU (``gpu``
marker); chip_smoke.py compares it with the reference on the card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_itu.models import IndexOptions, NSWBuilder
from hnsw_itu.models.base import ID_INF, device_memory_limit
from hnsw_itu.models.hnsw import HNSWBuilder
from hnsw_itu.models.nsw import _batch_pad, query_path
from hnsw_itu.ops import beam_kernel
from hnsw_itu.ops.metrics import get_metric
from hnsw_itu.utils import compile_cache


class _Dev:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself: the setting is left alone
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        d = compile_cache.enable()
        assert d == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert os.path.isdir(d)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_memory_limit_known(monkeypatch):
    monkeypatch.setattr(
        jax, "devices",
        lambda *a, **k: [_Dev({"bytes_limit": 63_763_120_128})])
    assert device_memory_limit() == 63_763_120_128


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_device_memory_limit_unknown(monkeypatch, stats):
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Dev(stats)])
    assert device_memory_limit() is None


def test_cpu_reports_no_memory_limit():
    assert device_memory_limit() is None  # the CPU: env budgets stand


def test_l2_pairwise_mxu_highest_precision():
    """The l2 matmul form must agree with the direct form to float32
    rounding, not to TF32's ~3 digits (the oracle's precision)."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(64, 96)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(80, 96)).astype(np.float32))
    m = get_metric("l2")
    got = np.asarray(m.pairwise_mxu(a, b))
    want = np.asarray(m.pairwise(a, b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    text = jax.jit(m.pairwise_mxu).lower(a, b).as_text()
    assert "HIGHEST" in text


def _index(kind, n=400):
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    cls = NSWBuilder if kind == "nsw" else HNSWBuilder
    b = cls(IndexOptions(host_warmup=0, ef_construction=16, connections=6,
                         max_connections=16, size=n, batch_size=64),
            metric="hamming")
    b.extend_batched(pts)
    return b.build(), rng


@pytest.mark.parametrize("kind", ["nsw", "hnsw"])
def test_planner_never_picks_kernel_on_cpu(kind):
    idx, rng = _index(kind)
    idx.enable_inline()
    assert idx.adj_pts is not None
    # kernel-eligible shapes, but no CUDA device: the XLA inline path
    assert beam_kernel.kernel_eligible("hamming", idx.n, 16, 32, 32)
    assert not beam_kernel.available()
    assert query_path(idx, 10, 32) == "inline"
    idx.use_kernel = False
    assert query_path(idx, 10, 32) == "inline"
    idx.adj_pts = None
    assert query_path(idx, 10, 32) == "gather"
    qs = rng.integers(0, 2**32, size=(5, 32), dtype=np.uint32)
    assert np.asarray(idx.knns(qs, 3, 16).ids).shape == (5, 3)


def test_kernel_eligibility_rules():
    ok = dict(metric_name="hamming", cap=1_000_000, W=64, words=32, ef=64)
    assert beam_kernel.kernel_eligible(**ok)
    assert not beam_kernel.kernel_eligible(**{**ok, "metric_name": "l2"})
    # built for 1024-bit sketches only
    for words in (8, 12, 16, 64):
        assert not beam_kernel.kernel_eligible(**{**ok, "words": words})
    assert not beam_kernel.kernel_eligible(**{**ok, "W": 129})
    assert not beam_kernel.kernel_eligible(**{**ok, "ef": 129})
    assert not beam_kernel.kernel_eligible(**ok, tie_bits=20)
    # 2^21 nodes: the clamp (1022) is still past half the range (512)
    assert beam_kernel.kernel_eligible(**{**ok, "cap": 1 << 21})
    # 10.12M nodes need 24 id bits: the clamp (126) would cut the beam
    assert not beam_kernel.kernel_eligible(**{**ok, "cap": 10_120_000})


def test_kernel_build_failure_is_kept(monkeypatch):
    """On a GPU whose kernel library does not build, ``make`` runs once per
    process; later calls fall back to the XLA loop without rebuilding."""
    import subprocess

    calls = []

    def failing_make(cmd, **kw):
        calls.append(cmd)
        raise subprocess.CalledProcessError(2, cmd, stderr="nvcc: not found")

    monkeypatch.setattr(beam_kernel, "_STATE", {})
    monkeypatch.setattr(beam_kernel.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(beam_kernel.subprocess, "run", failing_make)
    with pytest.warns(UserWarning, match="nvcc: not found"):
        assert not beam_kernel.available()
    with pytest.warns(UserWarning, match="earlier in this process"):
        assert not beam_kernel.available()
    assert len(calls) == 1
    with pytest.raises(OSError):
        beam_kernel._load()
    assert len(calls) == 1


def test_kernel_key_packing_roundtrip():
    """prepare packs (clamped distance, id) exactly as the reference's
    _beam_search_packed does; decode inverts it and maps the sentinel."""
    cap, words = 1_000_000, 32
    d0 = jnp.asarray([0, 17, 512, 1024], jnp.int32)
    eps = jnp.asarray([3, 999_999, 0, 123_456], jnp.int32)
    init, id_bits, max_d = beam_kernel.prepare(d0, eps, cap=cap, words=words)
    assert (id_bits, max_d) == (20, 1024)  # nothing clamped below 2^20
    np.testing.assert_array_equal(
        np.asarray(init), (np.asarray(d0) << 20) | np.asarray(eps))
    kinf = (max_d + 1) << id_bits
    keys = jnp.concatenate([init, jnp.asarray([kinf], jnp.int32)])
    d, i = beam_kernel.decode(keys, id_bits=id_bits, max_d=max_d,
                              inf=np.int32(2**31 - 1), id_inf=ID_INF)
    np.testing.assert_array_equal(np.asarray(d)[:4], np.asarray(d0))
    np.testing.assert_array_equal(np.asarray(i)[:4], np.asarray(eps))
    assert int(i[4]) == ID_INF and int(d[4]) == 2**31 - 1
    # past 2^20 nodes the key clamps the distance, never overflows int32
    init2, id_bits2, max_d2 = beam_kernel.prepare(
        d0, eps, cap=1 << 21, words=words)
    assert (id_bits2, max_d2) == (21, 1022)
    assert int(init2[3]) == (1022 << 21) | 123_456
    assert ((max_d2 + 1) << id_bits2) < 2**31


def test_query_batch_padding():
    assert _batch_pad(1024, 1024) == 1024  # full batches stay
    assert _batch_pad(1000, 1024) == 1024
    assert _batch_pad(5, 1024) == 8
    assert _batch_pad(1, 16384) == 1
    assert _batch_pad(10_000, 16384) == 16384


@pytest.mark.gpu
def test_beam_kernel_matches_reference():
    """On a CUDA GPU: the kernel's keys, visited and step counts equal the
    XLA reference (_beam_search_packed, dedup="beam", expand=1) for every
    query."""
    idx, rng = _index("nsw", n=3000)
    idx.enable_inline()
    qs = rng.integers(0, 2**32, size=(200, 32), dtype=np.uint32)
    idx.query_entry_sample = 64
    for ef in (16, 64):
        assert query_path(idx, ef, ef) == "kernel"
        got = idx.knns(qs, ef, ef)
        gs = idx.last_stats
        idx.use_kernel = False
        want = idx.knns(qs, ef, ef)
        ws = idx.last_stats
        idx.use_kernel = True
        np.testing.assert_array_equal(np.asarray(got.ids),
                                      np.asarray(want.ids))
        np.testing.assert_array_equal(np.asarray(got.dists),
                                      np.asarray(want.dists))
        np.testing.assert_array_equal(gs["visited_q"], ws["visited_q"])
        np.testing.assert_array_equal(gs["steps_q"], ws["steps_q"])
