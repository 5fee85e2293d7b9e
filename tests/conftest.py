"""Test harness config: run everything on a virtual 8-device CPU mesh.

The reference needed no multi-node testing (single process + rayon,
SURVEY.md §4); the device equivalent is
``--xla_force_host_platform_device_count`` so sharding tests exercise real
collectives without hardware. The platform is pinned to the CPU unless
``JAX_PLATFORMS`` names another (``JAX_PLATFORMS=cuda python -m pytest
tests/ -m gpu`` runs the card's tests on a GPU machine).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# CLI tests call compile_cache.enable(); keep the persistent cache OFF in
# the test processes: once the cache is on, XLA CHECK-aborts serializing the
# sharded CPU executables test_sharded compiles later in the suite. CPU
# compiles are fast.
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# Fast inner-loop tier (`pytest -m quick`): whole modules dominated by
# 8-device mesh collectives, scanned-build A/Bs or large builds are marked
# slow; everything else is quick. The split is by measured module
# wall-clock on a 1-core box (pytest --durations), not by importance —
# quick must stay under ~5 minutes there.
_SLOW_MODULES = {
    "test_sharded",        # 8-device mesh collectives
    "test_scanned",        # G-chunk scanned-build bit-exactness A/Bs
    "test_host_hier",      # native full-hierarchy builds
    "test_spill",          # spill-recovery builds
    "test_reorder",        # rebuilds per entry policy
    "test_example",        # end-to-end golden examples via runpy
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    """Tests marked ``gpu`` need a CUDA device (the beam kernel has no
    interpret mode). Decided here, at run time, never at import: here they
    skip; chip_smoke.py runs what they check on the card."""
    if request.node.get_closest_marker("gpu") and not any(
        d.platform == "gpu" for d in jax.devices()
    ):
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Free each module's compiled executables when it finishes.

    The full suite compiles 400+ distinct XLA programs in one process;
    holding every executable alive exhausts process resources and crashes
    the compiler with a segfault/abort ~85 tests in (observed repeatedly
    at whichever test lands there under reordering). Tests are
    independent across modules, so dropping the jit caches between
    modules costs only recompiles of shared helpers."""
    yield
    jax.clear_caches()
