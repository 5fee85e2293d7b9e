"""hnsw_itu — HNSW / NSW / brute-force K-NN framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the ``hnsw-itu``
Rust reference (HNSW over 1024-bit binary sketches, SISAP 2023 LAION
challenge): padded-array graphs in device memory, batched
frontier-expansion beam search (with a CUDA kernel for the query beam),
bitmask visited sets, matmul brute-force scans, bulk-synchronous batched
index construction, HDF5 ingest, index persistence and a CLI.
"""

import os
import warnings

from . import ops
from .graph import GraphArrays, make_graph
from .ops.metrics import Metric, get_metric, register_metric

__version__ = "0.1.0"

# every environment setting the package reads (defaults in the modules that
# read them)
ENV_SETTINGS = (
    "HNSW_INLINE_QUERY_BYTES", "HNSW_INLINE_BUILD_BYTES", "HNSW_HOST_WARMUP",
    "HNSW_SCAN_GROUP", "HNSW_SPLIT_CHUNK", "HNSW_REORDER_SHUFFLE",
    "HNSW_NATIVE_SO",
)


def warn_unknown_env(environ=os.environ) -> list[str]:
    """Warn about ``HNSW_*`` variables the package does not read (a typo,
    or a name from before the settings were renamed): they are ignored.
    Called once at import; returns the names it warned about."""
    unknown = sorted(k for k in environ
                     if k.startswith("HNSW_") and k not in ENV_SETTINGS)
    if unknown:
        warnings.warn(f"ignored environment variables {unknown}; the "
                      f"settings read are {list(ENV_SETTINGS)}",
                      stacklevel=2)
    return unknown


warn_unknown_env()
