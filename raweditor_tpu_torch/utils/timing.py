"""Stage timers and latency statistics.

The reference instruments nothing (its only timing note is a code
comment, reference: gpu/pipeline.rs:525); these are the structured
replacements: per-stage accumulators for the pipeline (decode / device /
encode splits) and percentile latency tracking for the interactive
loop — the BASELINE.md metrics (develops/sec, p50/p95 re-render).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1000 * self.totals[name] / max(self.counts[name], 1), 3
                ),
            }
            for name in sorted(self.totals)
        }


class LatencyStats:
    """Rolling latency samples with percentile summary."""

    def __init__(self, max_samples: int = 10_000):
        self.samples: List[float] = []
        self.max_samples = max_samples

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        if len(self.samples) >= self.max_samples:
            self.samples.pop(0)
        self.samples.append(seconds)

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        arr = np.asarray(self.samples) * 1000.0
        return {
            "count": len(arr),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p95_ms": round(float(np.percentile(arr, 95)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
            "mean_ms": round(float(arr.mean()), 3),
            "max_ms": round(float(arr.max()), 3),
        }
