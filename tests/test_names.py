"""Names users already hold: the former package name imports as an alias of
``hnsw_itu``, and ``HNSW_*`` environment variables the package does not
read are reported instead of silently ignored."""

import importlib
import os
import subprocess
import sys

import pytest

import hnsw_itu
from hnsw_itu.models.nsw import NSW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# former package names: sibling packages named hnsw_itu_<something>
ALIASES = sorted(
    d for d in os.listdir(ROOT)
    if d.startswith("hnsw_itu_")
    and os.path.isfile(os.path.join(ROOT, d, "__init__.py"))
)


def test_an_alias_exists():
    assert ALIASES


@pytest.mark.parametrize("old", ALIASES)
def test_alias_is_the_same_package(old):
    sys.modules.pop(old, None)
    with pytest.warns(FutureWarning, match="import hnsw_itu instead"):
        mod = importlib.import_module(old)
    assert mod is hnsw_itu
    nsw = importlib.import_module(f"{old}.models.nsw")
    assert nsw.NSW is NSW  # one copy of every class


@pytest.mark.parametrize("old", ALIASES)
def test_alias_runs_the_cli(old):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", f"{old}.cli", "--help"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "query-index" in out.stdout


def test_unknown_env_settings_warn():
    env = {"HNSW_HOST_WARMUP": "10", "HNSW_INLINE_QUERY_BYTES": "1e9",
           "HNSW_HOST_WARMUPP": "10", "HNSW_OLD_SCAN_GROUP": "2",
           "PATH": "/bin"}
    with pytest.warns(UserWarning, match="HNSW_HOST_WARMUPP"):
        got = hnsw_itu.warn_unknown_env(env)
    assert got == ["HNSW_HOST_WARMUPP", "HNSW_OLD_SCAN_GROUP"]


def test_known_env_settings_are_quiet(recwarn):
    env = {name: "1" for name in hnsw_itu.ENV_SETTINGS}
    assert hnsw_itu.warn_unknown_env(env) == []
    assert not recwarn.list


def test_env_settings_are_the_ones_read():
    """ENV_SETTINGS names exactly the HNSW_* variables the package reads."""
    import re

    read = set()
    pkg = os.path.join(ROOT, "hnsw_itu")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    read |= set(re.findall(r'"(HNSW_[A-Z_]+)"', fh.read()))
    assert read == set(hnsw_itu.ENV_SETTINGS)
