"""HDF5 dataset I/O — BufferedDataset parity.

Parity target: reference/cli/src/dataset.rs. The reference wraps the
hdf5 crate with chunked 50,000-row iteration (dataset.rs:117), row writes,
and file-level scalar attributes (dataset.rs:54-60 — note attrs are written
on the FILE, not the dataset). Here the same surface over h5py, yielding
numpy blocks (the device ingest path wants big contiguous chunks, not rows).
"""

from __future__ import annotations

import numpy as np

BUFFER_SIZE = 50_000  # dataset.rs:117


class BufferedDataset:
    """Chunked reader/writer for one HDF5 dataset."""

    def __init__(self, file, dataset, owns_file: bool):
        import h5py  # noqa: F401

        self.file = file
        self.dataset = dataset
        self._owns = owns_file

    # -- constructors (dataset.rs:15-52) -----------------------------------
    @classmethod
    def open(cls, path, dataset: str = "hamming") -> "BufferedDataset":
        import h5py

        f = h5py.File(path, "r")
        return cls(f, f[dataset], owns_file=True)

    @classmethod
    def create(cls, path, shape, dataset: str = "knns", dtype=np.uint64):
        import h5py

        f = h5py.File(path, "w")
        d = f.create_dataset(dataset, shape=shape, dtype=dtype)
        return cls(f, d, owns_file=True)

    @classmethod
    def with_file(cls, file, shape, dataset: str, dtype=np.uint64):
        d = file.create_dataset(dataset, shape=shape, dtype=dtype)
        return cls(file, d, owns_file=False)

    # -- attrs (dataset.rs:54-60: file-level scalar attrs) -----------------
    def add_attr(self, name: str, value) -> None:
        self.file.attrs[name] = value

    def get_attr(self, name: str):
        return self.file.attrs[name]

    # -- shape ---------------------------------------------------------------
    def size(self) -> int:
        return int(self.dataset.shape[0])

    @property
    def shape(self):
        return tuple(self.dataset.shape)

    # -- rows ----------------------------------------------------------------
    def write_row(self, data, row: int) -> None:
        self.dataset[row, ...] = np.asarray(data)

    def write_rows(self, data, start: int) -> None:
        data = np.asarray(data)
        self.dataset[start : start + data.shape[0], ...] = data

    def read_all(self) -> np.ndarray:
        return self.dataset[...]

    def iter_chunks(self, start: int = 0, length: int | None = None,
                    chunk: int = BUFFER_SIZE):
        """Yield [<=chunk, ...] numpy blocks — the 50k-row buffered iterator
        (dataset.rs:101-144), block-shaped for device ingest."""
        n = self.size()
        stop = n if length is None else min(n, start + length)
        for s in range(start, stop, chunk):
            yield self.dataset[s : min(s + chunk, stop)]

    def close(self):
        if self._owns:
            self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
