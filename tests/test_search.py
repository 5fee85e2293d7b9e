"""Beam-search kernel tests vs a numpy oracle of the same semantics plus
reference-style completeness checks (hnsw.rs:330-331)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_itu.ops import HAMMING, L2INT, batched_beam_search, beam_search

INT_INF = np.iinfo(np.int32).max


def oracle_beam_search(adj, dist_to_q, ep, ef):
    """Reference Alg-2 (nsw.rs:133-184) with bounded-beam relaxation —
    i.e. the exact semantics of ops.search.beam_search with expand=1."""
    beam = [(int(dist_to_q[ep]), ep, False)]  # (d, id, expanded)
    visited = {ep}
    while True:
        beam.sort(key=lambda t: (t[0], t[1]))
        beam[:] = beam[:ef]
        worst = beam[-1][0] if len(beam) == ef else INT_INF
        frontier = [t for t in beam if not t[2] and t[0] <= worst]
        if not frontier:
            break
        d, c, _ = min(frontier, key=lambda t: (t[0], t[1]))
        beam[beam.index((d, c, False))] = (d, c, True)
        for e in adj[c]:
            if e < 0 or e in visited:
                continue
            visited.add(e)
            beam.append((int(dist_to_q[e]), e, False))
    beam.sort(key=lambda t: (t[0], t[1]))
    out_d = [t[0] for t in beam] + [INT_INF] * (ef - len(beam))
    out_i = [t[1] for t in beam] + [INT_INF] * (ef - len(beam))
    return out_d[:ef], out_i[:ef]


def _random_graph(rng, n, w):
    adj = np.full((n, w), -1, np.int32)
    for v in range(n):
        deg = rng.integers(1, w + 1)
        nbrs = rng.choice(n, size=deg, replace=False)
        nbrs = nbrs[nbrs != v]
        adj[v, : len(nbrs)] = nbrs
    # make symmetric-ish connectivity: link v -> v+1 chain so it's connected
    for v in range(n - 1):
        if v + 1 not in adj[v]:
            adj[v, rng.integers(0, w)] = v + 1
    return adj


def test_matches_oracle_random_graphs():
    rng = np.random.default_rng(7)
    for trial in range(5):
        n, w, ef = 64, 6, 8
        adj = _random_graph(rng, n, w)
        pts = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
        q = rng.integers(0, 2**32, size=(32,), dtype=np.uint32)
        d2q = np.asarray(HAMMING.one_to_many(jnp.asarray(q), jnp.asarray(pts)))

        pts_j = jnp.asarray(pts)
        got = beam_search(
            lambda ids: pts_j[ids],
            jnp.asarray(adj),
            jnp.asarray(q),
            jnp.int32(0),
            ef=ef,
            metric=HAMMING,
            capacity=n,
        )
        want_d, want_i = oracle_beam_search(adj, d2q, 0, ef)
        np.testing.assert_array_equal(np.asarray(got.dists), want_d)
        np.testing.assert_array_equal(np.asarray(got.ids), want_i)


def test_line_graph_exact_nn():
    # integers 0..19 on a path graph; 4-NN of 5 must be {4,5,6,3} by |x-5|
    n = 20
    adj = np.full((n, 2), -1, np.int32)
    for v in range(n):
        c = 0
        if v > 0:
            adj[v, c] = v - 1
            c += 1
        if v < n - 1:
            adj[v, c] = v + 1
    pts = jnp.asarray(np.arange(n, dtype=np.int32)[:, None])
    q = jnp.asarray(np.array([5], np.int32))
    r = beam_search(
        lambda ids: pts[ids],
        jnp.asarray(adj),
        q,
        jnp.int32(0),
        ef=4,
        metric=L2INT,
        capacity=n,
    )
    assert sorted(np.asarray(r.ids).tolist()) == [3, 4, 5, 6]


def test_completeness_ef_equals_size():
    # searching with ef=size on a connected graph returns every node
    # (the reference asserts this on HNSW, hnsw.rs:330-331)
    rng = np.random.default_rng(11)
    n = 32
    adj = _random_graph(rng, n, 4)
    pts = jnp.asarray(rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32))
    q = pts[0]
    r = beam_search(
        lambda ids: pts[ids],
        jnp.asarray(adj),
        q,
        jnp.int32(0),
        ef=n,
        metric=HAMMING,
        capacity=n,
    )
    assert sorted(np.asarray(r.ids).tolist()) == list(range(n))
    assert int(r.visited) == n


def test_expand_multi_superset_quality():
    # E-way expansion must not lose the true nearest on a connected graph
    rng = np.random.default_rng(13)
    n = 128
    adj = _random_graph(rng, n, 8)
    pts_np = rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32)
    pts = jnp.asarray(pts_np)
    q = jnp.asarray(rng.integers(0, 2**32, size=(32,), dtype=np.uint32))
    r1 = beam_search(
        lambda ids: pts[ids], jnp.asarray(adj), q, jnp.int32(0),
        ef=n, metric=HAMMING, capacity=n, expand=4,
    )
    assert sorted(np.asarray(r1.ids).tolist()) == list(range(n))


def test_batched_matches_single():
    rng = np.random.default_rng(17)
    n, ef, B = 64, 8, 5
    adj = _random_graph(rng, n, 6)
    pts = jnp.asarray(rng.integers(0, 2**32, size=(n, 32), dtype=np.uint32))
    qs = jnp.asarray(rng.integers(0, 2**32, size=(B, 32), dtype=np.uint32))
    eps = jnp.zeros((B,), jnp.int32)
    batched = batched_beam_search(
        lambda ids: pts[ids], jnp.asarray(adj), qs, eps,
        ef=ef, metric=HAMMING, capacity=n,
    )
    for b in range(B):
        single = beam_search(
            lambda ids: pts[ids], jnp.asarray(adj), qs[b], jnp.int32(0),
            ef=ef, metric=HAMMING, capacity=n,
        )
        np.testing.assert_array_equal(
            np.asarray(batched.ids[b]), np.asarray(single.ids)
        )


@pytest.mark.parametrize("dedup", ["bitmask", "beam"])
def test_beam_search_tie_bitrev_isomorphism(dedup):
    """XLA-path tie decorrelation correctness via graph isomorphism:
    searching G with tie_bits=b equals searching the bitrev-relabeled G'
    with plain keys (ids mapped through the relabel, same dists/visited/
    steps). dedup='beam' exercises the packed-key branch (hamming bound
    fits), 'bitmask' the generic two-key branch."""
    import jax.numpy as jnp

    from hnsw_itu.ops.metrics import get_metric
    from hnsw_itu.ops.search import ID_INF, batched_beam_search

    cap, w, words, B, ef, E, bits = 256, 16, 32, 16, 24, 4, 8
    rng = np.random.default_rng(dedup == "beam")
    pts = rng.integers(0, 2**32, size=(cap, words), dtype=np.uint32)
    adj = np.full((cap, w), -1, np.int32)
    for i in range(cap):
        deg = rng.integers(w // 2, w + 1)
        adj[i, :deg] = rng.choice(cap, size=deg, replace=False)
    qs = rng.integers(0, 2**32, size=(B, words), dtype=np.uint32)
    seeds = np.stack(
        [rng.choice(cap, size=E, replace=False) for _ in range(B)]
    ).astype(np.int32)

    def bitrev_np(x):
        out = np.zeros_like(x)
        v = x.copy()
        for _ in range(bits):
            out = (out << 1) | (v & 1)
            v >>= 1
        return out

    e = bitrev_np(np.arange(cap, dtype=np.int32))
    pts2 = np.zeros_like(pts)
    pts2[e] = pts
    adj2 = np.full_like(adj, -1)
    adj2[e] = np.where(adj >= 0, e[np.clip(adj, 0, cap - 1)], -1)

    metric = get_metric("hamming")
    pj, aj = jnp.asarray(pts), jnp.asarray(adj)
    p2j, a2j = jnp.asarray(pts2), jnp.asarray(adj2)
    qj = jnp.asarray(qs)
    kw = dict(ef=ef, metric=metric, capacity=cap, expand=1, max_steps=256,
              dedup=dedup)
    ra = batched_beam_search(lambda i: pj[i], aj, qj, jnp.asarray(seeds),
                             tie_bits=bits, **kw)
    rb = batched_beam_search(lambda i: p2j[i], a2j, qj,
                             jnp.asarray(e[seeds]), tie_bits=0, **kw)
    ia, ib = np.asarray(ra.ids), np.asarray(rb.ids)
    ib_orig = np.where(ib != ID_INF, bitrev_np(np.clip(ib, 0, cap - 1)), ib)
    np.testing.assert_array_equal(np.asarray(ra.dists), np.asarray(rb.dists))
    np.testing.assert_array_equal(ia, ib_orig)
    np.testing.assert_array_equal(np.asarray(ra.visited),
                                  np.asarray(rb.visited))
    np.testing.assert_array_equal(np.asarray(ra.steps), np.asarray(rb.steps))
