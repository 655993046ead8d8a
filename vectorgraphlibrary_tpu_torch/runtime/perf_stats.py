"""Per-round performance samples and the AVG_PERF contract (the AVG_PERF part of
vectorgraphlibrary_tpu/runtime/perf_stats.py).

Reference `performance_stats.hpp:388-446` / `vgl_runtime.hpp:125-128`: each
measured round records edges/(wall time * 1e6) MTEPS; the report prints
AVG_PERF / MIN_PERF / MAX_PERF, which harnesses parse.
"""
from __future__ import annotations

import collections
from typing import Dict, List


class PerformanceStats:
    def __init__(self):
        self._sample_perf: Dict[str, List[float]] = collections.defaultdict(list)

    def save_algorithm_performance_stats(self, name: str, wall_s: float,
                                         edges_count: int) -> None:
        mteps = edges_count / max(wall_s, 1e-12) / 1.0e6
        self._sample_perf[name].append(mteps)

    def report_performance(self, name: str) -> float:
        """Prints the AVG_PERF/MIN_PERF/MAX_PERF MTEPS contract; returns avg MTEPS."""
        samples = self._sample_perf.get(name, [])
        if not samples:
            print("AVG_PERF: 0 MTEPS")
            return 0.0
        avg = sum(samples) / len(samples)
        print(f"{name} wall (graph500) perf: {avg:.2f} MTEPS")
        print(f"AVG_PERF: {avg:.2f} MTEPS")
        print(f"MIN_PERF: {min(samples):.2f} MTEPS")
        print(f"MAX_PERF: {max(samples):.2f} MTEPS")
        return avg
