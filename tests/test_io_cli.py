"""End-to-end I/O + CLI tests: HDF5 ingest, persistence, the five
subcommands, result-file format parity (1-based u64 ids + attrs)."""

import h5py
import numpy as np
import pytest

from hnsw_itu.cli import format_size_string, main
from hnsw_itu.models import Bruteforce, IndexOptions
from hnsw_itu.models.hnsw import HNSWBuilder
from hnsw_itu.models.nsw import NSWBuilder
from hnsw_itu.utils import (
    BufferedDataset,
    ResultAttrs,
    load_index,
    recall_files,
    save_index,
)


def _write_h5(path, rows):
    with h5py.File(path, "w") as f:
        f.create_dataset("hamming", data=rows.astype(np.uint64))


@pytest.fixture()
def data(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.integers(0, 2**63, size=(300, 16), dtype=np.uint64)
    qs = pts[:20] ^ np.uint64(3)  # queries near known points
    d, q = tmp_path / "data.h5", tmp_path / "queries.h5"
    _write_h5(d, pts)
    _write_h5(q, qs)
    return d, q, tmp_path


def test_buffered_dataset_roundtrip(tmp_path):
    p = tmp_path / "x.h5"
    rows = np.arange(64, dtype=np.uint64).reshape(4, 16)
    ds = BufferedDataset.create(p, (4, 16), "hamming")
    ds.write_rows(rows, 0)
    ds.add_attr("data", "hamming")
    ds.close()
    with BufferedDataset.open(p, "hamming") as ds2:
        assert ds2.size() == 4
        chunks = list(ds2.iter_chunks(chunk=3))
        assert [c.shape[0] for c in chunks] == [3, 1]
        np.testing.assert_array_equal(np.concatenate(chunks), rows)
        assert ds2.get_attr("data") == "hamming"


def test_format_size_string():
    assert format_size_string(100_000) == "100K"
    assert format_size_string(10_120_191) == "10M"
    assert format_size_string(42) == "42"


@pytest.mark.parametrize("kind", ["bruteforce", "nsw", "hnsw"])
def test_save_load_roundtrip(tmp_path, kind):
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 2**32, size=(200, 32), dtype=np.uint32)
    if kind == "bruteforce":
        idx = Bruteforce("hamming")
        idx.extend(pts)
        idx.build()
    else:
        cls = NSWBuilder if kind == "nsw" else HNSWBuilder
        b = cls(IndexOptions(host_warmup=0, ef_construction=16, connections=8,
                             max_connections=16, size=200), metric="hamming")
        b.extend_batched(pts)
        idx = b.build()
    q = pts[5]
    before = np.asarray(idx.search(q, 5, 16).ids)
    p = tmp_path / "idx.npz"
    save_index(p, idx, ResultAttrs(size=200, algo=kind))
    idx2, attrs = load_index(p)
    assert attrs.size == 200
    after = np.asarray(idx2.search(q, 5, 16).ids)
    np.testing.assert_array_equal(before, after)


def test_cli_query_groundtruth_evaluate(data, capsys):
    d, q, tmp = data
    res, gt = tmp / "result.h5", tmp / "gt.h5"
    rc = main(["-q", "query", "-d", str(d), "-Q", str(q), "-o", str(res),
               "-k", "5", "-e", "32", "-c", "32", "-m", "8", "-M", "16",
               "--sort"])
    assert rc == 0
    rc = main(["-q", "ground-truth", "-d", str(d), "-Q", str(q),
               "-o", str(gt), "-k", "5"])
    assert rc == 0

    with h5py.File(res) as f:
        ids = f["knns"][...]
        assert ids.shape == (20, 5)
        assert ids.dtype == np.uint64
        assert ids.min() >= 1  # 1-based ids (main.rs:277)
        assert f.attrs["algo"] == "Hnsw"
        assert "efc=32" in f.attrs["params"]
        assert f.attrs["size"] == "300"
    with h5py.File(gt) as f:
        assert f["knns"].shape == (20, 5)
        assert f["dists"].shape == (20, 5)
        # queries flip 2 bits in each of 16 words: exact NN distance == 32
        assert (f["dists"][...][:, 0] == 32).all()

    rec = recall_files(res, gt, 5)
    assert rec >= 0.8

    rc = main(["evaluate", str(res), str(gt), "-k", "5"])
    assert rc == 0
    assert "recall@5" in capsys.readouterr().out

    # --write-dists + --tie-tolerant: the distance-threshold metric reads
    # the result's own 'dists' dataset (>= id-set recall by construction)
    res2 = tmp / "result_d.h5"
    rc = main(["-q", "query", "-d", str(d), "-Q", str(q), "-o", str(res2),
               "-k", "5", "-e", "32", "-c", "32", "-m", "8", "-M", "16",
               "--sort", "--write-dists"])
    assert rc == 0
    with h5py.File(res2) as f:
        assert f["dists"].shape == (20, 5)
    rc = main(["evaluate", str(res2), str(gt), "-k", "5", "--tie-tolerant"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tie-tolerant recall@5" in out
    rec_id = float(out.split("recall@5:")[1].split()[0])
    rec_tt = float(out.split("tie-tolerant recall@5:")[1].split()[0])
    assert rec_tt >= rec_id >= 0.8


def test_cli_index_query_index_inspect(data, capsys):
    d, q, tmp = data
    idxf, res = tmp / "index.idx", tmp / "r2.h5"
    assert main(["-q", "index", "-d", str(d), "-o", str(idxf),
                 "-c", "16", "-m", "4", "-M", "8", "-a", "nsw"]) == 0
    assert main(["-q", "query-index", "-i", str(idxf), "-Q", str(q),
                 "-o", str(res), "-k", "3", "-e", "16"]) == 0
    with h5py.File(res) as f:
        assert f["knns"].shape == (20, 3)
    assert main(["-q", "inspect", str(idxf)]) == 0
    out = capsys.readouterr().out
    assert "base has 300 nodes" in out
    assert "query on whole index returned" in out


def test_cli_index_start_len(data):
    d, q, tmp = data
    idxf = tmp / "slice.idx"
    assert main(["-q", "index", "-d", str(d), "-o", str(idxf),
                 "-b", "100", "-l", "50", "-a", "bruteforce"]) == 0
    idx, attrs = load_index(idxf)
    assert idx.size() == 50
    assert attrs.format_size is False


def test_cli_metric_l2_end_to_end(tmp_path):
    """--metric generalization past the reference's hamming-only CLI: an
    l2 float dataset flows through query, ground-truth, and evaluate."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(240, 24)).astype(np.float32)
    qs = pts[:16] + rng.normal(scale=0.01, size=(16, 24)).astype(np.float32)
    d, q = tmp_path / "l2.h5", tmp_path / "l2q.h5"
    with h5py.File(d, "w") as f:
        f.create_dataset("l2", data=pts)
    with h5py.File(q, "w") as f:
        f.create_dataset("l2", data=qs)
    res, gt = tmp_path / "res.h5", tmp_path / "gt.h5"
    assert main(["-q", "query", "--metric", "l2", "-d", str(d), "-Q", str(q),
                 "-o", str(res), "-k", "5", "-e", "32", "-c", "32",
                 "-m", "8", "-M", "16", "--sort"]) == 0
    assert main(["-q", "ground-truth", "--metric", "l2", "-d", str(d),
                 "-Q", str(q), "-o", str(gt), "-k", "5"]) == 0
    with h5py.File(gt) as f:
        assert f["dists"].dtype == np.float64  # float metrics keep fractions
        # each query sits ~0.01 from its source point
        assert (f["dists"][...][:, 0] < 0.1).all()
    assert recall_files(res, gt, 5) >= 0.9


def test_cli_single_threaded_l2_rejected(tmp_path):
    """The host engine is hamming/l2int-only; -S with l2 must error, not
    silently fall back to a parallel build."""
    d = tmp_path / "l2.h5"
    with h5py.File(d, "w") as f:
        f.create_dataset("l2", data=np.zeros((10, 4), np.float32))
    with pytest.raises(SystemExit):
        main(["-q", "query", "--metric", "l2", "-S", "-d", str(d),
              "-Q", str(d), "-o", str(tmp_path / "r.h5")])
