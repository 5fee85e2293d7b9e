"""Visited-free ("beam" dedup) search mode vs the exact bitmask mode."""

import jax.numpy as jnp
import numpy as np

from hnsw_itu.models import Bruteforce, IndexOptions, NSWBuilder
from hnsw_itu.ops import HAMMING, beam_search


def _random_graph(rng, n, w):
    adj = np.full((n, w), -1, np.int32)
    for v in range(n):
        nbrs = rng.choice(n, size=rng.integers(1, w + 1), replace=False)
        nbrs = nbrs[nbrs != v]
        adj[v, : len(nbrs)] = nbrs
    for v in range(n - 1):
        if v + 1 not in adj[v]:
            adj[v, rng.integers(0, w)] = v + 1
    return adj


def test_beam_dedup_matches_bitmask_results():
    rng = np.random.default_rng(3)
    n, w, ef = 96, 6, 12
    adj = _random_graph(rng, n, w)
    pts = jnp.asarray(rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32))
    for t in range(4):
        q = jnp.asarray(rng.integers(0, 2**32, size=(32,), dtype=np.uint32))
        rb = beam_search(lambda i: pts[i], jnp.asarray(adj), q, jnp.int32(0),
                         ef=ef, metric=HAMMING, capacity=n, dedup="bitmask")
        rm = beam_search(lambda i: pts[i], jnp.asarray(adj), q, jnp.int32(0),
                         ef=ef, metric=HAMMING, capacity=n, dedup="beam")
        # both must find the same result set (revisit handling may differ in
        # *work*, not in what survives the beam on these graphs)
        np.testing.assert_array_equal(np.asarray(rb.ids), np.asarray(rm.ids))
        np.testing.assert_array_equal(np.asarray(rb.dists), np.asarray(rm.dists))


def test_beam_dedup_recall_on_index():
    rng = np.random.default_rng(33)
    n, nq, k = 2000, 50, 10
    pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 32), dtype=np.uint32)
    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)

    b = NSWBuilder(
        IndexOptions(host_warmup=0, ef_construction=64, connections=16,
                     max_connections=32, size=n, batch_size=128),
        metric="hamming",
    )
    b.extend_batched(pts)
    nsw = b.build()

    def recall(r):
        return sum(
            len(set(np.asarray(r.ids[i]).tolist())
                & set(np.asarray(gt.ids[i]).tolist()))
            for i in range(nq)
        ) / (nq * k)

    nsw.query_dedup = "bitmask"
    r_bit = recall(nsw.knns(qs, k, ef=64))
    nsw.query_dedup = "beam"
    r_beam = recall(nsw.knns(qs, k, ef=64))
    assert abs(r_bit - r_beam) <= 0.03, (r_bit, r_beam)
