"""Point3D example — the generic-distance path beyond Hamming.

Parity target: reference/examples/main.rs. A 10x10x10 integer grid
with squared-Euclidean distance; the 10-NN of (2, 4, 16) at k=10, ef=20
have distances 49,50,50,50,50,51,51,51,51,53 (README.md:62-74).

Run: python examples/point3d.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from hnsw_itu.models import IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder


def main():
    points = np.array(
        [(x, y, z) for x in range(10) for y in range(10) for z in range(10)],
        dtype=np.int32,
    )

    builder = HNSWBuilder(
        IndexOptions(
            connections=8,
            ef_construction=24,
            max_connections=32,
            size=len(points),
        ),
        metric="l2int",
    )
    builder.extend_batched(points)
    index = builder.build()

    query = np.array([2, 4, 16], dtype=np.int32)
    k, ef = 10, 20

    result = index.search(query, k, ef)
    print("Distance : Point")
    for d, i in zip(np.asarray(result.dists), np.asarray(result.ids)):
        print(f"{d} : Point3D{tuple(int(v) for v in points[i])}")
    return np.asarray(result.dists)


if __name__ == "__main__":
    dists = main()
    expected = [49, 50, 50, 50, 50, 51, 51, 51, 51, 53]
    if dists.tolist() == expected:
        print("\nOK: matches the reference golden output")
    else:
        print(f"\nMISMATCH: expected {expected}")
        sys.exit(1)
