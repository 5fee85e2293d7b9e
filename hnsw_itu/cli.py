"""Command-line interface — ``hnsw-itu`` binary parity.

Parity target: reference/cli/src/main.rs. Five subcommands with the
same flags and defaults (main.rs:486-821): ``query``, ``index``,
``query-index``, ``ground-truth``, ``inspect`` — plus ``evaluate`` (recall
computation, which the reference delegates to the external SISAP23 eval
submodule). Defaults: k=10, ef=96, efc=96, m=24, M=256, algorithm=hnsw
(main.rs:505-527); ground-truth k=100, sort=true (main.rs:707-712).
Result files carry 1-based u64 ids and the data/size/algo/buildtime/
querytime/params attributes (main.rs:262-309).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .models import IndexOptions
from .models.bruteforce import Bruteforce
from .models.hnsw import HNSW, HNSWBuilder
from .models.nsw import NSW, NSWBuilder
from .ops.metrics import sketches_from_u64
from .utils import (
    BufferedDataset,
    ResultAttrs,
    SearchStats,
    load_index,
    recall_files,
    save_index,
)
from .utils import logging as ulog

log = ulog.get("cli")

ALGOS = ("bruteforce", "nsw", "hnsw")
ID_INF = np.iinfo(np.int32).max
# inspect's connectivity check uses the real search path (k=ef=size, the
# reference's exact check, main.rs:793-800) up to this size; above it an
# ef=N sorted beam per lockstep step is prohibitive and a host BFS
# answers the same reachability question
SEARCH_CONN_MAX = 4096


def format_size_string(size: int) -> str:
    # main.rs:250-259
    if 90_000 <= size <= 110_000:
        return "100K"
    if 270_000 <= size <= 330_000:
        return "300K"
    if 9_000_000 <= size <= 11_000_000:
        return "10M"
    if 27_000_000 <= size <= 33_000_000:
        return "30M"
    if 90_000_000 <= size <= 110_000_000:
        return "100M"
    return str(size)


def _load_points(path, metric="hamming", start=0, length=None):
    """Stream the HDF5 dataset named after ``metric``. The reference is
    hamming-only (u64 sketch words, packed here to uint32); the l2/l2int
    generalization opens a same-named dataset of float32 / int32 vectors."""
    with BufferedDataset.open(path, metric) as ds:
        if metric == "hamming":
            blocks = [sketches_from_u64(b)
                      for b in ds.iter_chunks(start, length)]
        else:
            dt = np.float32 if metric == "l2" else np.int32
            blocks = [np.asarray(b, dtype=dt)
                      for b in ds.iter_chunks(start, length)]
    if not blocks:
        return np.zeros((0, 32), np.uint32)
    return np.concatenate(blocks, axis=0)


def build_index(datafile, algorithm: str, opts: IndexOptions,
                single_threaded: bool, start=None, length=None,
                metric: str = "hamming"):
    """build_index parity (main.rs:111-179): open, range-slice, build with
    progress + timing, fill ResultAttrs."""
    log.info("Opening %s", datafile)
    with BufferedDataset.open(datafile, metric) as ds:
        total = ds.size()
    skip = start or 0
    take = length if length is not None else total
    size = min(take, total - skip)
    if take != size:
        log.warning("Dataset range will be smaller than specified len (%d)", size)

    pts = _load_points(datafile, metric, start=skip, length=take)
    opts.size = size
    log.info("Building index size=%d algorithm=%s single_threaded=%s",
             size, algorithm, single_threaded)
    t0 = time.perf_counter()
    if algorithm == "bruteforce":
        idx = Bruteforce(metric)
        idx.extend(pts)
        idx.build()
    else:
        builder_cls = NSWBuilder if algorithm == "nsw" else HNSWBuilder
        if single_threaded:
            from . import native

            if metric not in native.METRIC_CODE:
                raise SystemExit(
                    f"--single-threaded builds need the native host engine, "
                    f"which supports {sorted(native.METRIC_CODE)} — not "
                    f"{metric!r}"
                )
            # exact sequential insert ordering (`--single-threaded`,
            # main.rs:203-210): route the whole build through the native
            # host engine (exact reference semantics, one thread)
            opts.host_warmup = size
        b = builder_cls(opts, metric=metric)

        def progress(done, total=size, _last=[0]):
            # build heartbeat every 100k rows with percent (main.rs:140-146)
            if done - _last[0] >= 100_000 or done >= total:
                _last[0] = done
                log.info("Processed %d/%d (%d%%)", done, total,
                         done * 100 // max(total, 1))

        b.extend_batched(pts, progress=progress)
        idx = b.build()
        drops = b.total_edge_drops()
        if drops:
            log.info("reverse-edge drops during build: %d (%.3f%% of %d "
                     "appended edges)", drops,
                     drops * 100.0 / max(size * opts.connections, 1),
                     size * opts.connections)
    buildtime = time.perf_counter() - t0
    log.info("Total build time: %.2fs, per element: %.2fus",
             buildtime, buildtime / max(size, 1) * 1e6)

    attrs = ResultAttrs(
        format_size=start is None and length is None,
        data=metric,
        size=size,
        algo={"bruteforce": "Bruteforce", "nsw": "Nsw", "hnsw": "Hnsw"}[algorithm],
        buildtime=buildtime,
        params=f"index=(efc={opts.ef_construction},m={opts.connections},"
               f"M={opts.max_connections})",
    )
    return idx, attrs


def query_index(queryfile, index, attrs: ResultAttrs, k: int, ef: int,
                single_threaded: bool = False):
    """query_index parity (main.rs:181-222)."""
    if k > ef:
        log.error("k=%d is greater than ef=%d, this can have adverse effects", k, ef)
    log.info("Opening %s", queryfile)
    qs = _load_points(queryfile, index.metric.name)
    log.info("Start querying k=%d ef=%d queries=%d single_threaded=%s",
             k, ef, qs.shape[0], single_threaded)
    t0 = time.perf_counter()
    if single_threaded and not isinstance(index, Bruteforce):
        # host engine, one thread: serial map over queries (main.rs:203-210)
        from . import native

        if index.metric.name not in native.METRIC_CODE:
            raise SystemExit(
                f"--single-threaded queries need the native host engine, "
                f"which supports {sorted(native.METRIC_CODE)} — not "
                f"{index.metric.name!r}"
            )

        points_np = np.asarray(index.points)
        eps = None
        if isinstance(index, HNSW):
            # per-level ef=1 greedy descent, following down-pointers —
            # exact HNSW::search semantics (hnsw.rs:285-293) on the host
            ep = index.ep
            eps = np.full((qs.shape[0],), ep, np.int32)
            for lv, n_l in zip(reversed(index.levels),
                               reversed(index.level_ns)):
                node_ids = np.asarray(lv.node_ids)[:n_l]
                pts_l = points_np[node_ids]
                _, loc = native.host_knns(
                    pts_l, index.metric.name,
                    np.ascontiguousarray(np.asarray(lv.graph.adj)[:n_l]),
                    np.ascontiguousarray(np.asarray(lv.graph.deg)[:n_l]),
                    n_l, qs, 1, 1, threads=1, eps=eps,
                )
                down = np.asarray(lv.down)[:n_l]
                eps = down[np.clip(loc[:, 0], 0, n_l - 1)].astype(np.int32)
            graph = index.base
        else:
            graph, eps = index.graph, np.full(
                (qs.shape[0],), index.ep, np.int32
            )
        dists, ids = native.host_knns(
            points_np, index.metric.name,
            np.ascontiguousarray(np.asarray(graph.adj)),
            np.ascontiguousarray(np.asarray(graph.deg)),
            index.size(), qs, k, ef, threads=1, eps=eps,
        )
        if getattr(index, "id_map", None) is not None:
            # reordered index: the host engine returns internal ids; map
            # back to original dataset ids like knns does
            idm = np.asarray(index.id_map)
            ids = np.where(ids >= ID_INF, ids,
                           idm[np.clip(ids, 0, idm.shape[0] - 1)])
    else:
        if hasattr(index, "enable_inline"):
            # inline neighbor rows: one contiguous read per expansion
            # (W x points extra memory)
            index.enable_inline()
        res = index.knns(qs, k, ef)
        ids = np.asarray(res.ids)
        dists = np.asarray(res.dists)
    querytime = time.perf_counter() - t0
    log.info("Total query time: %.3fs, per query: %.2fus",
             querytime, querytime / max(qs.shape[0], 1) * 1e6)
    # instrument-feature analytics (main.rs:71-109): per-graph-size visited
    # percentiles + total distance-call count
    stats = getattr(index, "last_stats", None)
    if stats and "visited_q" in stats:
        s = SearchStats(graph_size=index.size())
        s.record(stats["visited_q"], stats["steps_q"])
        s.report(log)
    attrs.querytime = querytime
    attrs.params = f"{attrs.params},query=(ef={ef})"
    return dists, ids


def _pad_short_results(ids, dists, k):
    """Indexes::search parity (main.rs:467-474): pad short rows by
    repeating the first valid element, with a warning."""
    bad = ids >= ID_INF
    if bad.any():
        log.warning("search returned fewer than k elements; padding")
        first = ids[:, :1]
        firstd = dists[:, :1]
        ids = np.where(bad, first, ids)
        dists = np.where(bad, firstd, dists)
    return ids, dists


def write_result(path, dists, ids, k, sort, attrs: ResultAttrs,
                 write_dists: bool = False):
    """write_result parity (main.rs:262-309): knns dataset of 1-based u64
    ids + file attrs. ``write_dists`` additionally stores the true
    distances as a ``dists`` dataset (no reference analogue in the query
    commands; ground-truth files always carry one, main.rs:733-750) —
    this is what ``evaluate --tie-tolerant`` consumes."""
    log.info("Writing result to %s sort=%s", path, sort)
    ids, dists = _pad_short_results(ids, dists, k)
    if sort:
        order = np.lexsort((ids, dists), axis=-1)
        ids = np.take_along_axis(ids, order, axis=-1)
        dists = np.take_along_axis(np.asarray(dists), order, axis=-1)
    out = BufferedDataset.create(path, (ids.shape[0], k), "knns")
    out.write_rows(ids.astype(np.uint64) + 1, 0)
    if write_dists:
        with_d = BufferedDataset.with_file(
            out.file, (ids.shape[0], k), "dists")
        with_d.write_rows(np.asarray(dists).astype(np.uint64), 0)
    size = format_size_string(attrs.size) if attrs.format_size else str(attrs.size)
    log.info("Writing result attributes data=%s size=%s algo=%s buildtime=%s "
             "querytime=%s params=%s", attrs.data, size, attrs.algo,
             attrs.buildtime, attrs.querytime, attrs.params)
    out.add_attr("data", attrs.data)
    out.add_attr("size", size)
    out.add_attr("algo", attrs.algo)
    out.add_attr("buildtime", attrs.buildtime)
    out.add_attr("querytime", attrs.querytime)
    out.add_attr("params", attrs.params)
    out.close()


def _opts_from_args(a) -> IndexOptions:
    return IndexOptions(
        ef_construction=a.ef_construction,
        connections=a.connections,
        max_connections=a.max_connections,
        reorder=getattr(a, "reorder", False),
    )


# -- subcommand actions ------------------------------------------------------

def cmd_query(a):
    idx, attrs = build_index(a.datafile, a.algorithm, _opts_from_args(a),
                             a.single_threaded, metric=a.metric)
    if a.indexfile:
        log.info("Serializing index to %s", a.indexfile)
        save_index(a.indexfile, idx, attrs)
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.ef,
                             a.single_threaded)
    write_result(a.outfile, dists, ids, a.k, a.sort, attrs,
                 write_dists=a.write_dists)


def cmd_index(a):
    idx, attrs = build_index(a.datafile, a.algorithm, _opts_from_args(a),
                             a.single_threaded, a.start, a.len,
                             metric=a.metric)
    log.info("Serializing index to %s (size=%d)", a.outfile, idx.size())
    save_index(a.outfile, idx, attrs)


def cmd_query_index(a):
    log.info("Reading index %s", a.indexfile)
    idx, attrs = load_index(a.indexfile)
    log.info("Read index size=%d", idx.size())
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.ef,
                             a.single_threaded)
    write_result(a.outfile, dists, ids, a.k, a.sort, attrs,
                 write_dists=a.write_dists)


def cmd_ground_truth(a):
    """ground-truth parity (main.rs:716-753): brute-force scan, write knns
    AND dists datasets (both u64, ids 1-based)."""
    idx, attrs = build_index(a.datafile, "bruteforce", IndexOptions(),
                             False, a.start, a.len, metric=a.metric)
    dists, ids = query_index(a.queryfile, idx, attrs, a.k, a.k)
    ids, dists = _pad_short_results(ids, dists, a.k)
    if a.sort:
        order = np.lexsort((ids, dists), axis=-1)
        ids = np.take_along_axis(ids, order, axis=-1)
        dists = np.take_along_axis(dists, order, axis=-1)
    log.info("Writing result to %s sort=%s", a.outfile, a.sort)
    import h5py

    with h5py.File(a.outfile, "w") as f:
        knns = BufferedDataset.with_file(f, (ids.shape[0], a.k), "knns")
        # u64 dists match the reference's hamming-only output
        # (main.rs:716-753); float metrics keep their fractional part
        ddt = np.float64 if a.metric == "l2" else np.uint64
        dd = BufferedDataset.with_file(f, (ids.shape[0], a.k), "dists",
                                       dtype=ddt)
        knns.write_rows(ids.astype(np.uint64) + 1, 0)
        dd.write_rows(dists.astype(ddt), 0)


def _reachability(adj: np.ndarray, n: int, ep: int) -> int:
    """Directed reachability from ``ep`` over the padded adjacency, by
    vectorized frontier BFS on the host (scale-safe replacement for the
    reference's whole-index search, main.rs:793-800)."""
    visited = np.zeros(n, bool)
    visited[ep] = True
    frontier = np.array([ep], np.int64)
    while frontier.size:
        nbrs = adj[frontier].ravel()
        nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
        nbrs = np.unique(nbrs)
        new = nbrs[~visited[nbrs]]
        visited[new] = True
        frontier = new
    return int(visited.sum())


def cmd_inspect(a):
    """inspect parity (main.rs:756-821): attrs, per-layer degree stats +
    percentiles, whole-index connectivity check."""
    idx, attrs = load_index(a.indexfile)
    print(attrs)

    def print_layer(name, deg, n):
        deg = np.sort(np.asarray(deg[:n]))
        total = int(deg.sum())
        print(f"\n{name} has {n} nodes, {total} total connections, "
              f"and {total // max(n,1)} average connections")
        print("connection distribution:")
        for i in range(11):
            j = min(n - 1, n // 10 * i)
            print(f"p{i*10} {int(deg[j])}")

    if isinstance(idx, Bruteforce):
        return
    if isinstance(idx, HNSW):
        for l in range(len(idx.levels) - 1, -1, -1):
            print_layer(f"layer{l}", idx.levels[l].graph.deg, idx.level_ns[l])
        print_layer("base", idx.base.deg, idx.n)
        graph, ep = idx.base, idx.base_ep()
    elif isinstance(idx, NSW):
        print_layer("base", idx.graph.deg, idx.n)
        graph, ep = idx.graph, idx.ep
    # connectivity: the reference searches the whole index with k=ef=size
    # (main.rs:793-800). Up to SEARCH_CONN_MAX nodes the SAME check runs
    # through this framework's real search path (one query, k=ef=size —
    # exercising entry + beam + dedup end to end); an ef=N sorted beam per
    # step is O(N log N) sort work on the device (effectively a hang at 1M),
    # so past the bound a host BFS over the adjacency arrays answers the
    # same reachability question in seconds at any scale.
    size = idx.size()
    if size <= SEARCH_CONN_MAX:
        q = np.asarray(idx.points[:1]).reshape(1, -1)  # node 0's point
        res = idx.knns(q, size, size)
        reached = int((np.asarray(res.ids)[0] < ID_INF).sum())
        how = "search with k=ef=size"
    else:
        reached = _reachability(np.asarray(graph.adj), size, ep)
        how = "host BFS from the entry point"
    print(f"\nquery on whole index returned {reached}/{size} elements "
          f"({how})")


def cmd_evaluate(a):
    rec = recall_files(a.result, a.truth, a.k)
    print(f"recall@{a.k or 'k'}: {rec:.5f}")
    if getattr(a, "tie_tolerant", False):
        from .utils.evalrecall import recall_tie_tolerant

        with BufferedDataset.open(a.result, "dists") as r:
            rd = r.read_all()
        with BufferedDataset.open(a.truth, "dists") as t:
            td = t.read_all()
        k = a.k or rd.shape[1]
        tt = recall_tie_tolerant(rd, td[:, : rd.shape[1]], k)
        print(f"tie-tolerant recall@{k}: {tt:.5f}")


# -- parser ------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hnsw-itu",
        description="HNSW/NSW/bruteforce K-NN index in JAX (hnsw-itu parity)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    sub = p.add_subparsers(dest="command", required=True)

    def common_build(sp):
        # generalization past the reference's hamming-only CLI: the HDF5
        # dataset is named after the metric (l2 = float32, l2int = int32)
        sp.add_argument("--metric", choices=["hamming", "l2", "l2int"],
                        default="hamming")
        sp.add_argument("-c", "--ef-construction", type=int, default=96)
        sp.add_argument("-m", "--connections", type=int, default=24)
        sp.add_argument("-M", "--max-connections", type=int, default=256)
        sp.add_argument("-a", "--algorithm", choices=ALGOS, default="hnsw")
        sp.add_argument("--reorder", action="store_true",
                        help="BFS-relabel the finished graph for memory "
                             "locality (results keep original ids; "
                             "no reference analogue). The XLA beam then "
                             "orders distance ties by bit-reversed id "
                             "(ops/search.bitrev_ids)")
        sp.add_argument("-S", "--single-threaded", action="store_true",
                        help="sequential inserts (exact reference ordering)")

    q = sub.add_parser("query", help="build, query, write result")
    q.add_argument("-d", "--datafile", required=True)
    q.add_argument("-Q", "--queryfile", required=True)
    q.add_argument("-o", "--outfile", default="result.h5")
    q.add_argument("-i", "--indexfile", default=None)
    q.add_argument("-k", type=int, default=10)
    q.add_argument("-e", "--ef", type=int, default=96)
    common_build(q)
    q.add_argument("-s", "--sort", action="store_true")
    q.add_argument("--write-dists", action="store_true",
                   help="also store true distances as a 'dists' dataset "
                        "(enables evaluate --tie-tolerant; no reference "
                        "analogue)")
    q.set_defaults(fn=cmd_query)

    ix = sub.add_parser("index", help="build and serialize an index")
    ix.add_argument("-d", "--datafile", required=True)
    ix.add_argument("-o", "--outfile", default="index.idx")
    ix.add_argument("-b", "--start", type=int, default=None)
    ix.add_argument("-l", "--len", type=int, default=None)
    common_build(ix)
    ix.set_defaults(fn=cmd_index)

    qi = sub.add_parser("query-index", help="query a serialized index")
    qi.add_argument("-i", "--indexfile", required=True)
    qi.add_argument("-Q", "--queryfile", required=True)
    qi.add_argument("-o", "--outfile", default="result.h5")
    qi.add_argument("-k", type=int, default=10)
    qi.add_argument("-e", "--ef", type=int, default=96)
    qi.add_argument("-s", "--sort", action="store_true")
    qi.add_argument("--write-dists", action="store_true",
                    help="also store true distances as a 'dists' dataset")
    qi.add_argument("-S", "--single-threaded", action="store_true")
    qi.set_defaults(fn=cmd_query_index)

    gt = sub.add_parser("ground-truth", help="exact k-NN via brute force")
    gt.add_argument("-d", "--datafile", required=True)
    gt.add_argument("-Q", "--queryfile", required=True)
    gt.add_argument("-o", "--outfile", default="groundtruth.h5")
    gt.add_argument("-b", "--start", type=int, default=None)
    gt.add_argument("-l", "--len", type=int, default=None)
    gt.add_argument("-k", type=int, default=100)
    gt.add_argument("-s", "--sort", action=argparse.BooleanOptionalAction,
                    default=True)
    gt.add_argument("--metric", choices=["hamming", "l2", "l2int"],
                    default="hamming")
    gt.set_defaults(fn=cmd_ground_truth)

    ins = sub.add_parser("inspect", help="read information from an index")
    ins.add_argument("indexfile")
    ins.set_defaults(fn=cmd_inspect)

    ev = sub.add_parser("evaluate", help="recall@k of a result vs ground truth")
    ev.add_argument("result")
    ev.add_argument("truth")
    ev.add_argument("-k", type=int, default=None)
    ev.add_argument("--tie-tolerant", action="store_true",
                    help="also report distance-threshold recall (immune "
                         "to k-boundary tie-break mismatch; needs dists "
                         "datasets in both files — write the result with "
                         "--write-dists)")
    ev.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None) -> int:
    from .utils.compile_cache import enable as enable_compile_cache

    enable_compile_cache()
    args = make_parser().parse_args(argv)
    ulog.setup(args.verbose - args.quiet)
    try:
        args.fn(args)
    except (FileNotFoundError, OSError, ValueError, KeyError) as e:
        # anyhow-style clean error surface (main.rs:31,63)
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
