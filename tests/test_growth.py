"""Dynamic capacity growth.

The reference's Vec-backed graph grows on add
(reference/src/collections/simplegraph.rs:82-87); the device builders
preallocate for static shapes but must no longer refuse points past
``IndexOptions.size`` — they reallocate at the next power of two
(amortized-doubling, the Vec contract) and continue.
"""

import numpy as np

from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder
from hnsw_itu.models.nsw import NSWBuilder


def _recall(ids, gt_ids, k):
    hits = 0
    for row, gt in zip(np.asarray(ids), np.asarray(gt_ids)):
        hits += len(set(row[:k].tolist()) & set(gt[:k].tolist()))
    return hits / (len(gt_ids) * k)


def test_nsw_grows_past_initial_size():
    rng = np.random.default_rng(3)
    n = 300  # initial capacity 128 -> grows to 512
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=128, batch_size=32),
        metric="hamming",
    )
    b.extend_batched(pts)
    assert b.opts.size == 512
    assert b.n == n
    idx = b.build()
    assert idx.size() == n

    qs = pts[:16] ^ np.uint32(3)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, 10)
    r = idx.knns(qs, 10, 48)
    assert _recall(r.ids, gt.ids, 10) >= 0.8
    # nothing may point past the live region after the reallocation
    adj = np.asarray(idx.graph.adj)
    assert adj[adj >= 0].max() < n


def test_nsw_sequential_growth():
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 2**32, size=(40, 32), dtype=np.uint32)
    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=16, connections=4,
                     max_connections=8, size=16),
        metric="hamming",
    )
    b.extend(pts)  # chunks of 1 through _insert_chunk
    assert b.n == 40
    assert b.opts.size == 64
    idx = b.build()
    r = idx.knns(pts[:8], 1, 16)
    assert (np.asarray(r.ids)[:, 0] == np.arange(8)).all()


def test_hnsw_grows_past_initial_size():
    rng = np.random.default_rng(5)
    n = 260
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    b = HNSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=32, connections=8,
                     max_connections=16, size=130, batch_size=32),
        metric="hamming",
    )
    b.extend_batched(pts)
    assert b.n == n
    assert b.opts.size >= n  # one doubling (130 -> 260); each growth
    # recompiles every chunk program, which dominates this test's cost
    idx = b.build()
    assert idx.size() == n

    qs = pts[:16] ^ np.uint32(3)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, 10)
    r = idx.knns(qs, 10, 48)
    assert _recall(r.ids, gt.ids, 10) >= 0.8
