from . import bitset
from .metrics import (
    HAMMING,
    L2,
    L2INT,
    Hamming,
    Metric,
    SquaredL2,
    SquaredL2Int,
    get_metric,
    register_metric,
    pack_bits_u32,
    sketches_from_u64,
    sketches_to_u64,
    unpack_bits_u32,
)
from .search import SearchResult, batched_beam_search, beam_search, greedy_search
from .select import select_neighbors
from .topk import merge_min_k, min_k, sort_by_dist

__all__ = [
    "bitset",
    "HAMMING",
    "L2",
    "L2INT",
    "Hamming",
    "Metric",
    "SquaredL2",
    "SquaredL2Int",
    "get_metric",
    "pack_bits_u32",
    "sketches_from_u64",
    "sketches_to_u64",
    "unpack_bits_u32",
    "SearchResult",
    "batched_beam_search",
    "beam_search",
    "greedy_search",
    "select_neighbors",
    "merge_min_k",
    "min_k",
    "sort_by_dist",
]
