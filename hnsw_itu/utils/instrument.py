"""Algorithmic instrumentation — visited/distance statistics.

Parity target: the ``instrument`` feature's post-run analytics
(reference/cli/src/main.rs:71-109): per-graph-size visited-node
statistics (total/mean/max/p25/p50/p75/p90/p99) and total distance-call
counts. The device search returns per-query visited counts and step
counts natively (ops/search.py), so the stats come for free instead of via
a capture layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SearchStats:
    graph_size: int = 0
    visited: list = field(default_factory=list)
    steps: list = field(default_factory=list)

    def record(self, visited, steps) -> None:
        self.visited.extend(np.asarray(visited).ravel().tolist())
        self.steps.extend(np.asarray(steps).ravel().tolist())

    def summary(self) -> dict:
        if not self.visited:
            return {}
        v = np.asarray(self.visited, np.float64)
        out = {
            "graph_size": self.graph_size,
            "queries": int(v.size),
            "visited_total": int(v.sum()),
            "visited_mean": float(v.mean()),
            "visited_max": int(v.max()),
        }
        for p in (25, 50, 75, 90, 99):
            out[f"visited_p{p}"] = float(np.percentile(v, p))
        if self.steps:
            s = np.asarray(self.steps, np.float64)
            out["steps_mean"] = float(s.mean())
        # each visited node costs exactly one distance call in the reference
        # hot loop (nsw.rs:156-166, sketch.rs:21-22)
        out["distance_calls"] = int(v.sum())
        return out

    def report(self, log) -> None:
        s = self.summary()
        if s:
            log.info("visited stats: %s", s)
