"""Capacity-aware inline budgets + warmup buffer lifecycle.

Budgets are read from the device's allocator limit
(``memory_stats()["bytes_limit"]``, models/base.device_memory_limit); the
tests patch that limit in. Also pinned: ``_host_warmup`` must free the
pre-warmup buffers before uploading replacements (old + new at once
doubles peak memory).
"""

import jax
import numpy as np
import pytest

import hnsw_itu.models.nsw as nswmod
from hnsw_itu.models import IndexOptions, NSWBuilder
from hnsw_itu.models.hnsw import HNSWBuilder

# what JAX reports on an 80 GB H100 at its default 75% memory fraction
H100_LIMIT = 63_763_120_128


class _Dev:
    def __init__(self, limit):
        self.limit = limit

    def memory_stats(self):
        return {"bytes_limit": self.limit, "bytes_in_use": 0}


def _patch_limit(monkeypatch, limit):
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Dev(limit)])


def test_inline_budget_env_only_on_cpu(monkeypatch):
    # the CPU reports no allocator limit: the raw env knob stands, else
    # its default
    monkeypatch.delenv("HNSW_INLINE_QUERY_BYTES", raising=False)
    assert nswmod._inline_budget("HNSW_INLINE_QUERY_BYTES", 10**9) \
        == int(1.1e10)
    monkeypatch.setenv("HNSW_INLINE_QUERY_BYTES", "12345678")
    assert nswmod._inline_budget("HNSW_INLINE_QUERY_BYTES", 10**9) \
        == 12345678


def test_inline_budget_capped_by_hbm(monkeypatch):
    monkeypatch.delenv("HNSW_INLINE_BUILD_BYTES", raising=False)
    _patch_limit(monkeypatch, int(10e9))
    # fixed set leaves 10 - 1.6 - 4.5 = 3.9e9 for the table
    got = nswmod._inline_budget("HNSW_INLINE_BUILD_BYTES",
                                int(4.5e9))
    assert got == int(10e9 - 1.6e9 - 4.5e9)
    # a large device: what the limit leaves, with no smaller default
    _patch_limit(monkeypatch, H100_LIMIT)
    assert nswmod._inline_budget("HNSW_INLINE_BUILD_BYTES",
                                 int(4.5e9)) == int(H100_LIMIT - 1.6e9 - 4.5e9)
    # the env knob is an override that only lowers the device budget
    monkeypatch.setenv("HNSW_INLINE_BUILD_BYTES", "2e9")
    assert nswmod._inline_budget("HNSW_INLINE_BUILD_BYTES",
                                 int(4.5e9)) == int(2e9)
    monkeypatch.setenv("HNSW_INLINE_BUILD_BYTES", "1e12")
    assert nswmod._inline_budget("HNSW_INLINE_BUILD_BYTES",
                                 int(4.5e9)) == int(H100_LIMIT - 1.6e9 - 4.5e9)


def test_build_words_at_flagship_scales(monkeypatch):
    """Build widths on an H100-sized device: full sketches up to 2^21
    nodes (the kernel's reach) and beyond, the widest prefix under the
    budget past that, and fixed set + table within the limit. 2M and 2^21
    land the full 32 words, 10M mw=22 (704-bit steering + exact
    re-score)."""
    monkeypatch.delenv("HNSW_INLINE_BUILD_BYTES", raising=False)
    _patch_limit(monkeypatch, H100_LIMIT)

    sample = np.zeros((1, 32), np.uint32)
    for size, want_mw in ((2_000_000, 32), (1 << 21, 32),
                          (10_000_000, 22)):
        b = HNSWBuilder(
            IndexOptions(size=size, max_connections=64, connections=24),
            metric="hamming",
        )
        mw = NSWBuilder._inline_build_words(b, sample)
        assert mw == want_mw, (size, mw)
        fixed = size * (32 * 4 + 64 * 4 + 4 + 32) + b._extra_fixed_bytes()
        table = mw * size * 64 * 4
        assert fixed + table <= H100_LIMIT - 1.6e9
    # a small device truncates harder, never past its limit
    _patch_limit(monkeypatch, int(8e9))
    b = HNSWBuilder(
        IndexOptions(size=2_000_000, max_connections=64, connections=24),
        metric="hamming",
    )
    mw = NSWBuilder._inline_build_words(b, sample)
    fixed = 2_000_000 * (32 * 4 + 64 * 4 + 4 + 32) + b._extra_fixed_bytes()
    assert 2 <= mw < 32
    assert fixed + mw * 2_000_000 * 64 * 4 <= 8e9 - 1.6e9


@pytest.mark.parametrize("size,fits", [(1_000_000, True), (1 << 21, True),
                                       (10_120_000, False)])
def test_query_table_fits_h100(monkeypatch, size, fits):
    """Exact inline query rows on an H100-sized device: they fit up to the
    kernel's 2^21 nodes (17.2 GB there); 10.12M needs 83 GB and is served
    by the gather path."""
    monkeypatch.delenv("HNSW_INLINE_QUERY_BYTES", raising=False)
    _patch_limit(monkeypatch, H100_LIMIT)
    pts = jax.ShapeDtypeStruct((size, 32), np.uint32)
    adj = jax.ShapeDtypeStruct((size, 64), np.int32)
    assert nswmod._inline_query_fits(pts, adj) is fits


def test_level_capacity_and_extra_bytes():
    b = HNSWBuilder(
        IndexOptions(size=10_000_000, max_connections=64, connections=24),
        metric="hamming",
    )
    # 2x the 416,667 expected level-0 nodes, pow2-rounded
    assert b._level_capacity(0) == 1 << 20
    assert b._level_capacity(1) == 1 << 16
    # level arrays total well under 0.5GB at 10M (the old 8x factor: 1.2GB)
    assert 2.5e8 < b._extra_fixed_bytes() < 4e8


def test_scanned_gate(monkeypatch):
    """Scanned dispatch must fall back to G=1 when the inline table's
    temporary copy would overflow the device."""
    n = 2048
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=16, connections=6,
                     max_connections=16, size=n, batch_size=64),
        metric="hamming",
    )
    b._ensure_points(pts)
    assert b._scanned_fits()  # CPU backend: no limit reported, fits
    _patch_limit(monkeypatch, H100_LIMIT)
    assert b._scanned_fits()  # tiny arrays fit a real card too
    _patch_limit(monkeypatch, 1_000_000)  # a 1MB device
    assert not b._scanned_fits()
    assert b._scan_group([64, 64, 64], 0, 64) == 1


@pytest.mark.parametrize("cls", [NSWBuilder, HNSWBuilder])
def test_warmup_frees_prewarmup_buffers(cls, monkeypatch):
    """_host_warmup must delete the pre-warmup zero buffers before
    uploading replacements — old+new simultaneously doubles peak HBM
    at large N)."""
    from hnsw_itu import native

    if not native.available():
        pytest.skip("native host engine unavailable")
    n = 600
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    # force a truncated inline buffer so adj_pts exists pre-warmup
    monkeypatch.setenv("HNSW_INLINE_BUILD_BYTES",
                       str(n * 16 * 4 * 4))
    b = cls(
        IndexOptions(host_warmup=n, ef_construction=16, connections=6,
                     max_connections=16, size=n, batch_size=64),
        metric="hamming",
    )
    b._ensure_points(pts)
    old_points, old_adj_pts = b.points, b.adj_pts
    assert old_adj_pts is not None
    got = b._host_warmup(pts)
    assert got == n
    assert old_points.is_deleted()
    assert old_adj_pts.is_deleted()
    assert not b.points.is_deleted() and not b.adj_pts.is_deleted()
