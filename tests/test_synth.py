"""Tests for the multi-scale synthetic sketch generator (utils/synth.py).

The generator is the benchmark-data contract: every headline number
(bench.py, chip_smoke.py) is measured on it, so its structure —
determinism, the ~151-bit sibling scale, and the coarse-to-fine distance
gradient that makes the data navigable (flat clusters are not) — is
load-bearing and pinned here.
"""

import numpy as np
import pytest

from hnsw_itu.utils.synth import WORDS, make_dataset, make_leaves, make_points


def _hamming(a, b):
    x = np.unpackbits((a ^ b).view(np.uint8), axis=-1)
    return x.sum(-1)


def test_shapes_dtype_determinism():
    pts, qs = make_dataset(7, 300, 40, n_leaf=16)
    assert pts.shape == (300, WORDS) and qs.shape == (40, WORDS)
    assert pts.dtype == np.uint32 and qs.dtype == np.uint32
    pts2, qs2 = make_dataset(7, 300, 40, n_leaf=16)
    assert np.array_equal(pts, pts2) and np.array_equal(qs, qs2)
    pts3, _ = make_dataset(8, 300, 40, n_leaf=16)
    assert not np.array_equal(pts, pts3)


def test_sibling_scale():
    # two points of the same leaf differ by two independent p=.08 flip
    # masks: expected distance 2p(1-p)*1024 ~ 151 bits
    rng = np.random.default_rng(0)
    leaf = make_leaves(rng, 1)
    a = make_points(rng, leaf, 200)
    b = make_points(rng, leaf, 200)
    d = _hamming(a, b)
    assert 120 < d.mean() < 185, d.mean()


def test_multiscale_gradient():
    # navigability = a monotone distance gradient: sibling (same leaf)
    # < same-mid cousin < unrelated (different root). Regenerate the
    # hierarchy by hand with one rng per level so group membership is
    # controlled.
    rng = np.random.default_rng(3)
    leaves = make_leaves(rng, 4096)  # leaf i descends from mid i%... (random)
    pts = make_points(rng, leaves[:1], 100)
    sib = _hamming(pts[:50], pts[50:])
    far = _hamming(pts[:50], make_points(rng, leaves[-1:], 50))
    # unrelated leaves sit near the 512-bit background; siblings ~151
    assert sib.mean() < 200 < 350 < far.mean(), (sib.mean(), far.mean())


def test_queries_share_clusters_with_points():
    # ground truth must be non-trivial: each query's nearest point should
    # be far below the 512-bit background (same-leaf neighbors exist)
    pts, qs = make_dataset(0, 2000, 32, n_leaf=16)
    best = np.array([
        _hamming(np.broadcast_to(q, pts.shape), pts).min() for q in qs
    ])
    assert best.mean() < 250, best.mean()


def test_distribution_profiles():
    """Robustness-sweep profiles: every profile keeps
    queries answerable (nearest point well below the 512-bit background),
    and the knobs move the right statistics."""
    from hnsw_itu.utils.synth import PROFILES

    stats = {}
    for prof in PROFILES:
        pts, qs = make_dataset(0, 4000, 16, profile=prof)
        best = np.array([
            _hamming(np.broadcast_to(q, pts.shape), pts).min() for q in qs
        ])
        assert best.mean() < 300, (prof, best.mean())
        stats[prof] = (pts, best)
    # 'tail' shares its cluster structure with 'default' but 20% of its
    # points are uniform distractors: distance from a default point to the
    # tail's overwritten rows sits at the ~512-bit background
    d_pts = stats["default"][0]
    t_pts = stats["tail"][0]
    changed = (d_pts != t_pts).any(axis=1)
    assert 0.15 < changed.mean() < 0.25, changed.mean()
    import pytest

    with pytest.raises(ValueError):
        make_dataset(0, 100, 4, profile="nope")


def test_recall_tie_tolerant():
    from hnsw_itu.utils import recall_at_k, recall_tie_tolerant

    # oracle: dists [3, 5, 5], ids [1, 2, 3]; ties at the k=3 boundary
    gt_ids = np.array([[1, 2, 3]])
    gt_d = np.array([[3, 5, 5]])
    # result picked a DIFFERENT member (id 9) of the d=5 tie set
    res_ids = np.array([[1, 2, 9]])
    res_d = np.array([[3, 5, 5]])
    assert recall_at_k(res_ids, gt_ids, 3) == pytest.approx(2 / 3)
    assert recall_tie_tolerant(res_d, gt_d, 3) == 1.0
    # a genuinely worse neighbor (d=6) is a miss in both metrics
    res_d2 = np.array([[3, 5, 6]])
    assert recall_tie_tolerant(res_d2, gt_d, 3) == pytest.approx(2 / 3)
