"""Custom user metric — the public extension point (register_metric).

The reference's generic path accepts ANY user point type with an integer
distance through the ``Point`` trait (reference/src/index/mod.rs:45-47,
demonstrated by Point3D, examples/main.rs:7-11). This framework's
equivalent is a ``Metric`` subclass registered by name: implement
``one_to_many`` (the beam-search expansion kernel shape — one query vs C
gathered points), optionally override ``pairwise``/``pairwise_mxu`` for
dense blocks, and register. The name then works everywhere a built-in
does — builders, Bruteforce, serialization, and the jitted query steps
(they re-resolve metrics by name).

This example registers Manhattan (L1) distance over int32 vectors, builds
an HNSW index with it, and cross-checks the 5-NN against the exact
brute-force scan using the same metric.

Run: python examples/custom_metric.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from hnsw_itu import Metric, register_metric
from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder


class ManhattanInt(Metric):
    """Integer L1 distance: sum(|a_i - b_i|). Like the reference's
    ``Point::distance -> usize``, distances are integers (int32)."""

    def __init__(self):
        super().__init__(name="l1int")

    def one_to_many(self, q, pts):
        return jnp.sum(
            jnp.abs(pts.astype(jnp.int32) - q.astype(jnp.int32)), axis=-1
        )


def main():
    register_metric(ManhattanInt(), overwrite=True)

    rng = np.random.default_rng(0)
    points = rng.integers(-50, 50, size=(2000, 8), dtype=np.int32)
    query = rng.integers(-50, 50, size=(8,), dtype=np.int32)
    k, ef = 5, 32

    builder = HNSWBuilder(
        IndexOptions(connections=8, ef_construction=32, max_connections=16,
                     size=len(points), host_warmup=0),
        metric="l1int",
    )
    builder.extend_batched(points)
    index = builder.build()
    approx = index.search(query, k, ef)

    bf = Bruteforce("l1int")
    bf.extend(points)
    exact = bf.build().search(query, k, ef)

    print("approx:", np.asarray(approx.dists).tolist())
    print("exact :", np.asarray(exact.dists).tolist())
    return np.asarray(approx.dists), np.asarray(exact.dists)


if __name__ == "__main__":
    a, e = main()
