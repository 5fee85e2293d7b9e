"""Public metric extension point: a user-registered
Metric must work end-to-end through builders, search, brute force, and
serialization — the reference's generic ``Point`` path
(src/index/mod.rs:45-47)."""

import numpy as np
import pytest

from hnsw_itu import Metric, get_metric, register_metric
from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.nsw import NSWBuilder
from hnsw_itu.ops import metrics as metrics_mod


class _Chebyshev(Metric):
    def __init__(self, name="chebyshev-test"):
        super().__init__(name=name)

    def one_to_many(self, q, pts):
        import jax.numpy as jnp

        return jnp.max(
            jnp.abs(pts.astype(jnp.int32) - q.astype(jnp.int32)), axis=-1
        )


@pytest.fixture
def chebyshev():
    m = register_metric(_Chebyshev(), overwrite=True)
    yield m
    metrics_mod._REGISTRY.pop(m.name, None)


def test_register_and_resolve(chebyshev):
    assert get_metric("chebyshev-test") is chebyshev


def test_register_rejects_duplicates_and_junk(chebyshev):
    with pytest.raises(ValueError, match="already registered"):
        register_metric(_Chebyshev())
    with pytest.raises(TypeError):
        register_metric(object())  # not a Metric
    register_metric(_Chebyshev(), overwrite=True)  # explicit replace OK


def test_custom_metric_end_to_end(chebyshev):
    rng = np.random.default_rng(2)
    pts = rng.integers(-100, 100, size=(400, 6), dtype=np.int32)
    qs = rng.integers(-100, 100, size=(8, 6), dtype=np.int32)
    k = 5

    bf = Bruteforce("chebyshev-test")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)
    # oracle sanity: matches a numpy evaluation of the same metric
    d0 = np.max(np.abs(pts[None, :, :] - qs[:, None, :]), axis=-1)
    np.testing.assert_array_equal(
        np.sort(np.asarray(gt.dists), axis=1), np.sort(d0, axis=1)[:, :k]
    )

    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=len(pts)),
        metric="chebyshev-test",
    )
    b.extend_batched(pts)
    idx = b.build()
    r = idx.knns(qs, k, 48)
    hits = sum(
        len(set(np.asarray(r.ids)[i].tolist())
            & set(np.asarray(gt.ids)[i].tolist()))
        for i in range(len(qs))
    )
    assert hits / (len(qs) * k) >= 0.8


def test_custom_metric_serialization_roundtrip(chebyshev, tmp_path):
    from hnsw_itu.utils.serialize import load_index, save_index

    rng = np.random.default_rng(3)
    pts = rng.integers(-100, 100, size=(200, 6), dtype=np.int32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=16, connections=4,
                     max_connections=8, size=len(pts)),
        metric="chebyshev-test",
    )
    b.extend_batched(pts)
    idx = b.build()
    p = tmp_path / "idx"
    save_index(str(p), idx)
    idx2, _attrs = load_index(str(p))
    assert idx2.metric.name == "chebyshev-test"
    r1 = idx.knns(pts[:4], 3, 16)
    r2 = idx2.knns(pts[:4], 3, 16)
    np.testing.assert_array_equal(np.asarray(r1.ids), np.asarray(r2.ids))


def test_example_runs(chebyshev):
    import examples.custom_metric as ex

    approx, exact = ex.main()
    # top-1 must agree with the exact scan on this easy data
    assert approx[0] == exact[0]


def test_overwrite_invalidates_compiled_kernels():
    """register_metric(overwrite=True) must drop jit caches: compiled
    query steps are keyed by the static metric NAME, so a same-shape
    call after a replace would silently keep the OLD distance fn."""
    class _A(Metric):
        def __init__(self):
            super().__init__(name="swap-test")

        def one_to_many(self, q, pts):
            import jax.numpy as jnp

            return jnp.sum(
                jnp.abs(pts.astype(jnp.int32) - q.astype(jnp.int32)), axis=-1
            )

    class _B(_A):
        def one_to_many(self, q, pts):
            return super().one_to_many(q, pts) * 2  # visibly different

    try:
        register_metric(_A(), overwrite=True)
        pts = np.arange(8, dtype=np.int32)[:, None]
        qs = np.zeros((2, 1), np.int32)
        bf = Bruteforce("swap-test")
        bf.extend(pts)
        d1 = np.asarray(bf.build().knns(qs, 3).dists)  # compiles with _A
        register_metric(_B(), overwrite=True)
        bf2 = Bruteforce("swap-test")
        bf2.extend(pts)  # SAME shapes -> would hit the stale executable
        d2 = np.asarray(bf2.build().knns(qs, 3).dists)
        np.testing.assert_array_equal(d2, d1 * 2)
    finally:
        metrics_mod._REGISTRY.pop("swap-test", None)
