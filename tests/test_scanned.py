"""Scanned multi-chunk build dispatch (_build.chunk_steps_scanned).

The grouped path must be BIT-IDENTICAL to the per-chunk path for NSW (same
bulk-synchronous op sequence, one dispatch instead of G), and
recall-equivalent for HNSW (upper-level points of a group insert before the
group's level-0 sub-chunks — a documented reordering relaxation mirroring
the reference's own chunk-wide relaxation, nsw.rs:224-277).
"""

import numpy as np
import pytest

from hnsw_itu.models import Bruteforce, IndexOptions, NSWBuilder
from hnsw_itu.models.hnsw import HNSWBuilder


def _opts(n, scan_group, batch_size=16, connections=8, max_connections=16):
    # batch_size=16 -> max_chunk=256; schedule reaches steady state at
    # n=2048, leaving 8 full 256-chunks for n=4096 (two scan groups of 4)
    return IndexOptions(
        host_warmup=0,
        ef_construction=32,
        connections=connections,
        max_connections=max_connections,
        size=n,
        batch_size=batch_size,
        scan_group=scan_group,
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n, nq = 4096, 32
    pts = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(nq, 8), dtype=np.uint32)
    return pts, qs


@pytest.fixture(scope="module")
def clustered():
    """256-bit sketches around 64 planted centers (uniform random data is
    pathologically hard for graph navigation at small ef — recall there
    says nothing about build quality)."""
    rng = np.random.default_rng(11)
    n, nq, words = 4096, 32, 8
    centers = rng.integers(0, 2**32, size=(64, words), dtype=np.uint32)

    def perturb(base, flips):
        out = base.copy()
        for row in out:
            for b in rng.integers(0, 32 * words, size=flips):
                row[b // 32] ^= np.uint32(1 << (b % 32))
        return out

    pts = perturb(centers[rng.integers(0, 64, size=n)], 24)
    qs = perturb(centers[rng.integers(0, 64, size=nq)], 24)
    return pts, qs


@pytest.mark.parametrize(
    "m,M",
    [(8, 16),   # the plain config
     (14, 16)], # m close to W: heavy reverse-edge overflow -> the spill
                # buffer and prune budget churn every chunk, stressing
                # that the grouped carry evolves them identically
)
def test_scanned_nsw_bitexact(data, m, M):
    pts, _ = data
    n = pts.shape[0]

    graphs = []
    for g in (1, 4):
        b = NSWBuilder(_opts(n, g, connections=m, max_connections=M),
                       metric="hamming")
        b.extend_batched(pts)
        nsw = b.build()
        graphs.append((np.asarray(nsw.graph.adj), np.asarray(nsw.graph.deg),
                       nsw.ep, nsw.n, b.total_edge_drops()))
    (adj1, deg1, ep1, n1, dr1), (adj4, deg4, ep4, n4, dr4) = graphs
    assert n1 == n4 == n
    assert ep1 == ep4
    assert dr1 == dr4
    np.testing.assert_array_equal(deg1, deg4)
    np.testing.assert_array_equal(adj1, adj4)


def test_scanned_hnsw_recall(clustered):
    pts, qs = clustered
    n, k = pts.shape[0], 10

    bf = Bruteforce("hamming")
    bf.extend(pts)
    gt = bf.build().knns(qs, k)
    gt_sets = [set(np.asarray(gt.ids[i]).tolist()) for i in range(len(qs))]

    recalls = []
    level_ns = []
    for g in (1, 4):
        b = HNSWBuilder(_opts(n, g), metric="hamming")
        b.extend_batched(pts)
        h = b.build()
        level_ns.append(tuple(h.level_ns))
        r = h.knns(qs, k, 32)
        hits = sum(
            len(set(np.asarray(r.ids[i]).tolist()) & gt_sets[i])
            for i in range(len(qs))
        )
        recalls.append(hits / (len(qs) * k))
    # identical RNG stream -> identical per-point level draws
    assert level_ns[0] == level_ns[1]
    # the reordering relaxation must not cost graph quality
    assert recalls[1] >= recalls[0] - 0.03
    assert recalls[1] >= 0.75


def test_scanned_gating_ramp_only():
    """Groups engage only on steady-state full chunks: a build smaller
    than the steady threshold never calls the scanned path."""
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 2**32, size=(1500, 8), dtype=np.uint32)
    b = NSWBuilder(_opts(1500, 4), metric="hamming")
    called = []
    orig = b._insert_chunks_scanned
    b._insert_chunks_scanned = lambda *a: called.append(a) or orig(*a)
    b.extend_batched(pts)
    assert not called  # n=1500 never reaches a full group of 256-chunks
    nsw = b.build()
    assert nsw.n == 1500


def test_scanned_eps0_supplied_entries():
    """chunk_steps_scanned_prewritten must START searches at supplied
    eps0 rows (HNSW's descent-chained upper-level points) and fall back
    to the sampled entry for -1 rows. Two far-apart clusters + a one-step
    search budget make the entry choice observable in the adjacency."""
    import jax.numpy as jnp

    from hnsw_itu.graph import make_graph, set_rows
    from hnsw_itu.models import _build

    words = 8
    # cluster A = rows 0..3 (zeros-ish), cluster B = rows 4..7 (ones)
    pts = np.zeros((16, words), np.uint32)
    pts[4:8] = 0xFFFFFFFF
    # two new points that BELONG to B: rows 8 and 9
    pts[8:10] = 0xFFFFFFFF
    pts[8, 0] ^= 1  # tiny perturbation
    pts[9, 0] ^= 3
    points = jnp.asarray(pts)

    def build_graph():
        g = make_graph(16, 4)
        # A and B are internally connected rings with NO cross edges
        rows = np.full((8, 4), -1, np.int32)
        for v in range(4):
            rows[v, 0] = (v + 1) % 4
            rows[v + 4, 0] = 4 + (v + 1) % 4
        return set_rows(g, jnp.arange(8, dtype=jnp.int32), jnp.asarray(rows))

    node_map = jnp.arange(16, dtype=jnp.int32)
    chunks = points[8:10]
    new_ids = jnp.asarray([8, 9], jnp.int32)
    n0s = jnp.asarray([8], jnp.int32)

    def run(eps0):
        # fresh graph AND spill per call: both are donated by the jit
        g, _, _, _ = _build.chunk_steps_scanned_prewritten(
            points, node_map, build_graph(), None, _build.make_spill(16),
            chunks, new_ids, n0s,
            None if eps0 is None else jnp.asarray(eps0, jnp.int32),
            G=1, cp=2, S=2, efc=2, m=2, metric_name="hamming",
            max_steps=1, entry_sample=1, prune_budget=4,
        )
        return np.asarray(g.adj[8:10])

    # entry_sample=1 samples only row 0 (cluster A); max_steps=1 keeps the
    # beam inside the entry's cluster -> links land in A
    adj_default = run(None)
    assert set(adj_default.ravel()) - {-1} <= set(range(4)), adj_default
    # supplied entries in cluster B -> links land in B
    adj_supplied = run([4, 5])
    assert set(adj_supplied.ravel()) - {-1} <= set(range(4, 8)), adj_supplied
    # mixed: row 0 supplied (B), row 1 sampled (A)
    adj_mixed = run([4, -1])
    assert set(adj_mixed[0]) - {-1} <= set(range(4, 8)), adj_mixed
    assert set(adj_mixed[1]) - {-1} <= set(range(4)), adj_mixed
