"""Headline benchmark: batched HNSW query throughput at the recall@10 gate.

Reference baseline (BASELINE.md): 26.4k QPS at recall@10 = 0.9336 on the 10M
laion2B hamming dataset, 16-thread CPU (ef=64, efc=96, m=24, M=256). The
LAION data is not available here, so the benchmark runs on synthetic
1024-bit sketches (utils/synth.py), measures exact recall against the
brute-force oracle, and reports batched QPS on one CUDA GPU, timed on the
host clock around work that ends in ``jax.block_until_ready``. Prints one
JSON line per scale; every record names the card, its power limit and the
device as JAX reports it.

The recall gate is enforced: recall@10 < 0.93 prints an error JSON and
exits nonzero instead of reporting a healthy-looking QPS. A run that finds
no GPU fails.

Scale knobs via env: BENCH_N (default 100_000), BENCH_Q (default 10_000),
BENCH_SECOND_N (default 1_000_000; 0 disables), BENCH_EF (default 32),
BENCH_W (max degree, default 64).
"""

import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

RECALL_GATE = 0.93
K = 10


def card() -> str:
    """'<name>, <power limit>' as nvidia-smi reports the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run_scale(N, NQ, ef):
    import jax
    import jax.numpy as jnp

    from hnsw_itu.models import Bruteforce, IndexOptions
    from hnsw_itu.models.hnsw import HNSWBuilder
    from hnsw_itu.models.nsw import query_path
    from hnsw_itu.utils import recall_at_k
    from hnsw_itu.utils.synth import make_dataset

    pts, qs = make_dataset(0, N, NQ)

    # exact ground truth BEFORE the index exists: the oracle's bit table
    # and the inline query table need not share the device
    t0 = time.perf_counter()
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt_ids = np.asarray(bf.build().knns(qs, K).ids)
    del bf
    gc.collect()
    print(f"# ground truth: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    W = int(os.environ.get("BENCH_W", 64))
    opts = IndexOptions(ef_construction=96, connections=24,
                        max_connections=W, size=N, batch_size=256,
                        host_warmup=min(50_000, N))
    t0 = time.perf_counter()
    b = HNSWBuilder(opts, metric="hamming")
    b.extend_batched(pts)
    index = b.build()
    jax.block_until_ready(index.base.adj)
    build_s = time.perf_counter() - t0
    print(f"# build: {build_s:.1f}s ({build_s/N*1e6:.1f} us/pt), "
          f"levels={index.level_ns}", file=sys.stderr)

    index.query_batch = NQ
    index.query_entry_sample = 1024
    qs_dev = jnp.asarray(qs)
    jax.block_until_ready(index.knns(qs_dev, K, ef))  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = jax.block_until_ready(index.knns(qs_dev, K, ef))
        best = min(best, time.perf_counter() - t0)
    recall = recall_at_k(np.asarray(res.ids), gt_ids, K)
    qps = NQ / best
    dev = jax.devices()[0]
    record = {
        "metric": f"HNSW batched QPS (k={K}, ef={ef}, n={N}, synthetic "
                  f"1024-bit sketches, recall gate)",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / 26_400, 3),
        "recall_at_10": round(recall, 4),
        "build_seconds": round(build_s, 1),
        "n_points": N,
        "n_queries": NQ,
        "query_path": query_path(index, K, ef),
        "card": card(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if recall < RECALL_GATE:
        record["error"] = (f"recall@10 {recall:.4f} below the {RECALL_GATE} "
                           "gate — QPS void")
    del index, b
    gc.collect()
    return record


def main():
    import jax

    from hnsw_itu.ops import beam_kernel
    from hnsw_itu.utils.compile_cache import enable

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX's default backend is "
                 f"{jax.default_backend()!r}, not a GPU")
    enable()
    # build the CUDA kernel up front (warns if it cannot; each record's
    # query_path then shows the XLA fallback)
    beam_kernel.available()
    NQ = int(os.environ.get("BENCH_Q", 10_000))
    EF = int(os.environ.get("BENCH_EF", 32))
    record = run_scale(int(os.environ.get("BENCH_N", 100_000)), NQ, EF)
    print(json.dumps(record), flush=True)
    if "error" in record:
        sys.exit(4)
    n2 = int(os.environ.get("BENCH_SECOND_N", 1_000_000))
    if n2 and n2 != record["n_points"]:
        rec2 = run_scale(n2, NQ, EF)
        print(json.dumps(rec2), flush=True)
        if "error" in rec2:
            sys.exit(4)


if __name__ == "__main__":
    main()
