"""Instrumentation analytics wiring (main.rs:71-109 parity)."""

import logging

import numpy as np

from hnsw_itu.models import IndexOptions
from hnsw_itu.models.nsw import NSWBuilder
from hnsw_itu.utils import SearchStats


def test_search_stats_wired_through_knns():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 2**32, size=(400, 32), dtype=np.uint32)
    b = NSWBuilder(IndexOptions(ef_construction=32, connections=8,
                                max_connections=16, size=400, batch_size=64,
                                host_warmup=0), metric="hamming")
    b.extend_batched(pts)
    idx = b.build()
    idx.knns(pts[:32], 5, 16)

    st = idx.last_stats
    assert st["queries"] == 32
    assert st["visited_q"].shape == (32,)
    assert st["visited"] == int(st["visited_q"].sum()) > 0

    s = SearchStats(graph_size=idx.size())
    s.record(st["visited_q"], st["steps_q"])
    out = s.summary()
    for field in ("graph_size", "queries", "visited_total", "visited_mean",
                  "visited_max", "visited_p25", "visited_p50", "visited_p75",
                  "visited_p90", "visited_p99", "steps_mean",
                  "distance_calls"):
        assert field in out, field
    assert out["queries"] == 32
    assert out["visited_total"] == st["visited"]
    # one distance call per visited node (nsw.rs:156-166, sketch.rs:21-22)
    assert out["distance_calls"] == out["visited_total"]


def test_cli_reports_stats(tmp_path, caplog):
    import h5py

    from hnsw_itu.cli import main
    from hnsw_itu.ops.metrics import sketches_to_u64

    rng = np.random.default_rng(1)
    pts = rng.integers(0, 2**32, size=(300, 32), dtype=np.uint32)
    data, quer = tmp_path / "d.h5", tmp_path / "q.h5"
    with h5py.File(data, "w") as f:
        f.create_dataset("hamming", data=sketches_to_u64(pts))
    with h5py.File(quer, "w") as f:
        f.create_dataset("hamming", data=sketches_to_u64(pts[:16]))

    with caplog.at_level(logging.INFO, logger="hnsw_itu.cli"):
        assert main(["query", "-d", str(data), "-Q", str(quer),
                     "-o", str(tmp_path / "r.h5"), "-k", "5", "-e", "32",
                     "-c", "32", "-m", "8", "-M", "16"]) == 0
    text = caplog.text
    assert "visited stats" in text
    assert "visited_p99" in text
