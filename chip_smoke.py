"""Smoke run of the HNSW build and query path on one CUDA GPU.

Drives the library's main path through its normal entry points —
``HNSWBuilder.extend_batched`` -> ``build()`` (which materializes the
inline query table) -> ``knns`` — at the reference benchmark's query
settings, and checks it with the repo's own means:

  * the exact ``Bruteforce`` oracle on the card, itself checked against the
    native host oracle on 1,000 queries (dists identical; ids may differ
    only among equal distances at the k boundary);
  * the CUDA beam kernel against the plain XLA reference
    (``ops/search._beam_search_packed``, dedup="beam", expand=1) on every
    query at ef=32 and 64: identical ids, dists, visited and step counts;
  * recall@10 >= 0.93 at ef=64 (the reference's gate).

Default size: 1,000,000 synthetic 1024-bit sketches
(``utils/synth.make_dataset``), 10,000 queries, k=10, efc=96, m=24, M=64,
a 1,024-point sampled entry, ef=32 and ef=64. ``--n 10120000`` runs the
SISAP 2023 10.12M scale.

``--chips 4`` runs only the multi-card path: 4,000,000 points, 1M per
card, built and queried as a ``ShardedHNSW`` over a 1-D mesh of 4 GPUs
(recall@10 >= 0.93 at ef=64 against the oracle), and
``knns_query_sharded`` over the 4 cards against single-card
``HNSW.knns`` (ids identical).

Exits non-zero, printing no result line, when JAX's default backend is not
a GPU, the native host engine or the CUDA kernel cannot be built, or any
check fails. The last line of a passing run is one JSON object naming the
device.

    python chip_smoke.py            # one card
    python chip_smoke.py --chips 4  # four cards
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

K = 10
RECALL_GATE = 0.93
EFS = (32, 64)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def timed(fn, reps: int = 3):
    """(best seconds over ``reps`` runs after one warm-up, last result);
    each run ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    best, res = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, res


def check_oracle(pts, qs, gt_d, gt_i, n_check: int = 1000) -> None:
    """GPU oracle vs the native host oracle on ``n_check`` queries."""
    from hnsw_itu import native

    n_check = min(n_check, qs.shape[0])
    hd, hi = native.host_bruteforce(pts, "hamming", qs[:n_check], K)
    gd, gi = gt_d[:n_check], gt_i[:n_check]
    if not np.array_equal(hd, gd):
        fail(f"oracle dists differ from the host oracle on "
             f"{int((hd != gd).any(axis=1).sum())} of {n_check} queries")
    kth = gd[:, -1:]
    inner_same = all(
        set(gi[r][gd[r] < kth[r]]) == set(hi[r][hd[r] < kth[r]])
        for r in range(n_check)
    )
    if not inner_same:
        fail("oracle ids below the k-th distance differ from the host oracle")
    # ids that differ must sit at the k-th distance: recompute on the host
    diff = gi != hi
    rows, cols = np.nonzero(diff)
    if rows.size:
        x = pts[gi[rows, cols]] ^ qs[rows]
        d = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
        if not np.array_equal(d, kth[rows, 0]):
            fail("oracle ids differ from the host oracle off the k boundary")
    log(f"oracle vs host oracle on {n_check} queries: dists identical, "
        f"{int(diff.any(axis=1).sum())} queries differ only in ids tied at "
        f"the k-th distance")


def ground_truth(pts, qs):
    from hnsw_itu.models import Bruteforce

    t0 = time.perf_counter()
    bf = Bruteforce("hamming")
    bf.extend(pts)
    res = bf.build().knns(qs, K)
    gt_d, gt_i = np.asarray(res.dists), np.asarray(res.ids)
    log(f"oracle: {qs.shape[0]} queries x {pts.shape[0]} points in "
        f"{time.perf_counter() - t0:.1f}s")
    # free the oracle's device tables before the index allocates its own
    del bf, res
    gc.collect()
    return gt_d, gt_i


def build_index(pts, *, batch_size: int = 256):
    import jax

    from hnsw_itu.models import IndexOptions
    from hnsw_itu.models.hnsw import HNSWBuilder

    n = pts.shape[0]
    opts = IndexOptions(ef_construction=96, connections=24,
                        max_connections=64, size=n, batch_size=batch_size,
                        host_warmup=min(50_000, n))
    t0 = time.perf_counter()
    b = HNSWBuilder(opts, metric="hamming")
    b.extend_batched(pts)
    index = b.build()
    jax.block_until_ready((index.base.adj, index.adj_pts))
    s = time.perf_counter() - t0
    log(f"build: N={n} in {s:.1f}s = {s / n * 1e6:.2f} us/point "
        f"(levels {index.level_ns}, edge drops {b.total_edge_drops()}, "
        f"inline table {'yes' if index.adj_pts is not None else 'no'})")
    return index


def query_and_compare(index, qs, gt_i, nq):
    import jax.numpy as jnp

    from hnsw_itu.models.nsw import query_path
    from hnsw_itu.ops import beam_kernel
    from hnsw_itu.utils import recall_at_k

    index.query_batch = nq
    index.query_entry_sample = 1024
    qd = jnp.asarray(qs)
    recall = {}
    for ef in EFS:
        path = query_path(index, K, ef)
        if (path != "kernel" and index.adj_pts is not None
                and beam_kernel.kernel_eligible(
                    "hamming", index.base.capacity, index.base.width, 32,
                    ef)):
            fail(f"kernel-eligible index served by the {path} path")
        t, res = timed(lambda: index.knns(qd, K, ef))
        recall[ef] = recall_at_k(np.asarray(res.ids), gt_i, K)
        log(f"query ef={ef} [{path}]: {nq / t:.0f} QPS ({t * 1e3:.2f} ms "
            f"for {nq} queries), recall@10={recall[ef]:.4f}")
        if path != "kernel":
            continue
        # the XLA reference path end to end, then the exact comparison of
        # whole beams (k=ef) with the kernel
        index.use_kernel = False
        tx, _ = timed(lambda: index.knns(qd, K, ef), reps=2)
        ref = index.knns(qd, ef, ef)
        rs = index.last_stats
        index.use_kernel = True
        got = index.knns(qd, ef, ef)
        gs = index.last_stats
        log(f"  XLA reference path ef={ef}: {nq / tx:.0f} QPS "
            f"({tx * 1e3:.2f} ms); XLA/kernel time ratio {tx / t:.1f}")
        for name, a, b in (
            ("ids", got.ids, ref.ids), ("dists", got.dists, ref.dists),
            ("visited", gs["visited_q"], rs["visited_q"]),
            ("steps", gs["steps_q"], rs["steps_q"]),
        ):
            a, b = np.asarray(a), np.asarray(b)
            bad = int((a != b).reshape(a.shape[0], -1).any(axis=1).sum())
            if bad:
                fail(f"kernel vs reference ef={ef}: {name} differ on {bad} "
                     f"of {nq} queries")
        log(f"  kernel vs reference ef={ef}: ids, dists, visited and steps "
            f"identical on all {nq} queries (mean steps "
            f"{gs['steps'] / nq:.1f}, visited {gs['visited'] / nq:.1f})")
    if recall[64] < RECALL_GATE:
        fail(f"recall@10 {recall[64]:.4f} at ef=64 is below {RECALL_GATE}")


def run_one(args) -> None:
    import jax

    from hnsw_itu.utils.synth import make_dataset

    t0 = time.perf_counter()
    pts, qs = make_dataset(args.seed, args.n, args.queries)
    log(f"data: {args.n} points, {args.queries} queries in "
        f"{time.perf_counter() - t0:.1f}s")
    gt_d, gt_i = ground_truth(pts, qs)
    check_oracle(pts, qs, gt_d, gt_i)
    index = build_index(pts)
    query_and_compare(index, qs, gt_i, args.queries)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device memory: {stats.get('peak_bytes_in_use', 0) / 1e9:.2f} "
        f"GB of {stats.get('bytes_limit', 0) / 1e9:.2f} GB")


def run_four(args) -> None:
    import jax
    import jax.numpy as jnp

    from hnsw_itu.models import IndexOptions
    from hnsw_itu.parallel import ShardedHNSW, knns_query_sharded
    from hnsw_itu.parallel.mesh import make_mesh
    from hnsw_itu.utils import recall_at_k
    from hnsw_itu.utils.synth import make_dataset

    if len(jax.devices()) < 4:
        fail(f"--chips 4 needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh(4)
    n = 4 * args.n
    t0 = time.perf_counter()
    pts, qs = make_dataset(args.seed, n, args.queries)
    log(f"data: {n} points, {args.queries} queries in "
        f"{time.perf_counter() - t0:.1f}s")
    gt_d, gt_i = ground_truth(pts, qs)

    # index sharding: one shard of args.n points per card
    opts = IndexOptions(ef_construction=96, connections=24,
                        max_connections=64, size=n, batch_size=1024)
    t0 = time.perf_counter()
    idx = ShardedHNSW.build(pts, opts, metric="hamming", mesh=mesh)
    idx.enable_inline()
    jax.block_until_ready((idx.adj_s, idx.adj_pts_s))
    s = time.perf_counter() - t0
    log(f"sharded build: {n} points over 4 cards in {s:.1f}s = "
        f"{s / n * 1e6:.2f} us/point (edge drops {idx.total_edge_drops()}, "
        f"per-shard inline rows {'yes' if idx.adj_pts_s is not None else 'no'})")
    recall = {}
    for ef in EFS:
        path = idx._query_path(K, ef)
        t, res = timed(lambda: idx.knns(qs, K, ef))
        recall[ef] = recall_at_k(np.asarray(res.ids), gt_i, K)
        log(f"sharded query ef={ef} [{path}]: {args.queries / t:.0f} QPS "
            f"({t * 1e3:.2f} ms), recall@10={recall[ef]:.4f}")
    if recall[64] < RECALL_GATE:
        fail(f"sharded recall@10 {recall[64]:.4f} at ef=64 is below "
             f"{RECALL_GATE}")
    del idx
    gc.collect()

    # query sharding: a single-card HNSW replicated over the 4 cards
    index = build_index(pts[: args.n])
    index.query_batch = args.queries
    index.query_entry_sample = 1024
    single = index.knns(jnp.asarray(qs), K, 64)
    t, shr = timed(lambda: knns_query_sharded(index, qs, K, 64, mesh=mesh))
    same = np.array_equal(np.asarray(single.ids), np.asarray(shr.ids))
    log(f"knns_query_sharded over 4 cards ef=64: {args.queries / t:.0f} QPS; "
        f"ids identical to single-card HNSW.knns: {same}")
    if not same:
        fail("knns_query_sharded ids differ from single-card HNSW.knns")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="points (per card with --chips 4)")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        fail(f"JAX's default backend is {jax.default_backend()!r}, not a GPU")
    from hnsw_itu import native
    from hnsw_itu.ops import beam_kernel
    from hnsw_itu.utils import compile_cache

    compile_cache.enable()
    if not native.available():
        fail("the native host engine (native/libhnsw_host.so) is unavailable")
    # built here, before any phase is timed
    if not beam_kernel.available():
        fail("the CUDA beam kernel (native/beam_search.cu) did not build")
    dev = jax.devices()[0]
    log(f"card: {card_name_and_power()}")
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    if args.chips == 4:
        run_four(args)
    else:
        run_one(args)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
