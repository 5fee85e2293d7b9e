"""Tracing-style logging setup.

Parity target: the tracing-subscriber fmt layer with HH:MM:SS timestamps and
clap-verbosity flags (reference/cli/src/main.rs:31-61). Span-prefixed
lines (``build_index: ...``) are emulated with the logger name.
"""

from __future__ import annotations

import logging
import sys
import time


def setup(verbosity: int = 0) -> None:
    """verbosity: -1 quiet(-q), 0 default(warn+info pipeline), 1 -v debug,
    2 -vv trace-ish."""
    level = {
        -2: logging.CRITICAL,
        -1: logging.ERROR,
        0: logging.INFO,
        1: logging.DEBUG,
    }.get(max(-2, min(verbosity, 1)), logging.DEBUG)
    handler = logging.StreamHandler(sys.stderr)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)5s %(name)s: %(message)s", datefmt="%H:%M:%S"
    )
    fmt.converter = time.localtime
    handler.setFormatter(fmt)
    root = logging.getLogger("hnsw_itu")
    root.handlers[:] = [handler]
    root.setLevel(level)


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"hnsw_itu.{name}")
