"""Host-engine microbenchmark: sequential build rate (µs/point).

The native warmup engine inserts the first `host_warmup` (default 50k)
points of every batched build sequentially (exact reference semantics,
nsw.rs:234-235); `--single-threaded` builds run entirely through it. This
measures its insert rate on the local CPU at the CLI's default build
parameters so optimizations to native/hnsw_host.cpp are verifiable without
a GPU. Reference calibration: 16-core Ryzen builds 10.12M points in
575s ≈ 56.8 µs/pt (README.md:160-184) — but its warmup phase is one core,
like this measurement.
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=20_000)
    ap.add_argument("--words", type=int, default=32)
    ap.add_argument("-m", type=int, default=24)
    ap.add_argument("-M", type=int, default=64)
    ap.add_argument("--efc", type=int, default=96)
    ap.add_argument("--hnsw", action="store_true",
                    help="full-hierarchy build (hnsw_host_build_hnsw)")
    args = ap.parse_args()

    from hnsw_itu import native

    assert native.available()
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 2**32, size=(args.n, args.words), dtype=np.uint32)
    adj = np.full((args.n, args.M), -1, np.int32)
    deg = np.zeros((args.n,), np.int32)

    t0 = time.perf_counter()
    if args.hnsw:
        ml = 16
        draws = np.zeros((args.n,), np.int32)
        g = np.random.default_rng(7)
        draws[1:] = g.geometric(1 - 1 / args.m, size=args.n - 1) - 1
        caps = [max(8, int(8 * args.n * (1 / args.m) ** (l + 1)))
                for l in range(ml)]
        total = sum(caps)
        ln = np.zeros((total,), np.int32)
        ld = np.zeros((total,), np.int32)
        la = np.full((total, args.M), -1, np.int32)
        lg = np.zeros((total,), np.int32)
        lns = np.zeros((ml,), np.int64)
        done, _ = native.host_build_hnsw(
            pts, "hamming", adj, deg, 1, args.n, m=args.m, efc=args.efc,
            draws=draws, level_caps=caps, lvl_node_ids=ln, lvl_down=ld,
            lvl_adj=la, lvl_deg=lg, level_ns=lns, ep=0)
    else:
        done = native.host_build(pts, "hamming", adj, deg, 1, args.n,
                                 m=args.m, efc=args.efc, ep=0)
    dt = time.perf_counter() - t0
    rate = dt / (args.n - 1) * 1e6
    print(f"n={args.n} words={args.words} m={args.m} M={args.M} "
          f"efc={args.efc} hnsw={args.hnsw}: {dt:.2f}s = {rate:.1f} us/pt")


if __name__ == "__main__":
    main()
