"""Persistent XLA compilation cache setup.

Call early (before the first jit) — used by the CLI, bench.py and
chip_smoke.py. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this leaves JAX's setting alone; otherwise the cache lives at
one fixed path inside the checkout, ``<repo>/.jax_cache`` (git-ignored): a
fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """Where the persistent cache lives for this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return cache_dir()
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
