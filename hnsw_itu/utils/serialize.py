"""Index persistence — whole-index save/load.

Parity target: the bincode blob ``IndexFile{attrs, index}`` of the reference
(reference/cli/src/main.rs:225-248, 480-484). Array redesign: one
uncompressed ``.npz`` holding the flat device arrays (points, adjacency,
levels) plus a JSON metadata record — directly mmap-able back onto the device
uploads, no pointer rebuild like bincode needs.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

import jax.numpy as jnp
import numpy as np

from ..graph import GraphArrays
from ..models import IndexOptions
from ..models.bruteforce import Bruteforce
from ..models.hnsw import HNSW, Level
from ..models.nsw import NSW

FORMAT_VERSION = 1


@dataclass
class ResultAttrs:
    """Run metadata persisted with results/indexes (main.rs:311-334)."""

    format_size: bool = True
    data: str = "hamming"
    size: int = 0
    algo: str = "Bruteforce"
    buildtime: float = 0.0
    querytime: float = 0.0
    params: str = ""


def save_index(path, index, attrs: ResultAttrs | None = None) -> None:
    attrs = attrs or ResultAttrs()
    meta = {
        "version": FORMAT_VERSION,
        "metric": index.metric.name,
        "attrs": asdict(attrs),
        "opts": asdict(getattr(index, "opts", IndexOptions())),
    }
    arrays = {}
    if isinstance(index, Bruteforce):
        meta["kind"] = "bruteforce"
        meta["n"] = index.size()
        arrays["points"] = np.concatenate(index._chunks, axis=0)[: index.size()]
    elif isinstance(index, NSW):
        meta["kind"] = "nsw"
        meta["n"] = index.n
        meta["ep"] = index.ep
        arrays["points"] = np.asarray(index.points)
        arrays["adj"] = np.asarray(index.graph.adj)
        arrays["deg"] = np.asarray(index.graph.deg)
    elif isinstance(index, HNSW):
        meta["kind"] = "hnsw"
        meta["n"] = index.n
        meta["ep"] = index.ep
        meta["level_ns"] = index.level_ns
        arrays["points"] = np.asarray(index.points)
        arrays["adj"] = np.asarray(index.base.adj)
        arrays["deg"] = np.asarray(index.base.deg)
        for l, lv in enumerate(index.levels):
            arrays[f"l{l}_node_ids"] = np.asarray(lv.node_ids)
            arrays[f"l{l}_down"] = np.asarray(lv.down)
            arrays[f"l{l}_adj"] = np.asarray(lv.graph.adj)
            arrays[f"l{l}_deg"] = np.asarray(lv.graph.deg)
    else:
        raise TypeError(f"cannot serialize index type {type(index)!r}")
    if getattr(index, "id_map", None) is not None:
        # reordered index (NSW/HNSW.reorder): persist the new->original id
        # map so loaded indexes keep returning original dataset ids
        arrays["id_map"] = np.asarray(index.id_map)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_index(path):
    """Returns (index, ResultAttrs)."""
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported index format version {meta.get('version')}")
    attrs = ResultAttrs(**meta["attrs"])
    opts = IndexOptions(**meta["opts"])
    kind = meta["kind"]
    if kind == "bruteforce":
        idx = Bruteforce(meta["metric"])
        idx.extend(z["points"])
        idx.build()
    elif kind == "nsw":
        idx = NSW(
            jnp.asarray(z["points"]),
            meta["n"],
            GraphArrays(jnp.asarray(z["adj"]), jnp.asarray(z["deg"])),
            meta["ep"],
            meta["metric"],
            opts,
        )
    elif kind == "hnsw":
        levels = []
        for l in range(len(meta["level_ns"])):
            levels.append(
                Level(
                    jnp.asarray(z[f"l{l}_node_ids"]),
                    jnp.asarray(z[f"l{l}_down"]),
                    GraphArrays(
                        jnp.asarray(z[f"l{l}_adj"]), jnp.asarray(z[f"l{l}_deg"])
                    ),
                )
            )
        idx = HNSW(
            jnp.asarray(z["points"]),
            meta["n"],
            GraphArrays(jnp.asarray(z["adj"]), jnp.asarray(z["deg"])),
            levels,
            meta["level_ns"],
            meta["ep"],
            meta["metric"],
            opts,
        )
    else:
        raise ValueError(f"unknown index kind {kind!r}")
    if "id_map" in getattr(z, "files", ()):
        idx.id_map = jnp.asarray(z["id_map"])
    return idx, attrs
