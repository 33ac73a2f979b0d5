"""Spans, counters and latency statistics.

``StageTimer`` is the port's one recorder of where time goes. Every
thread of a batch export (decode, upload, fetch and encode workers and
the calling thread) adds to one recorder under one lock:

- ``span(name, image=, batch=, parent=)`` times a block and adds its
  duration to ``totals[name]`` and one to ``counts[name]``; with a log
  kept (``keep_log``) it also appends the span, with its thread, the
  image and flush it belongs to and its parent span's name;
- ``interval(name, start_ns, end_ns, ...)`` does the same for a span
  timed from two ``perf_counter_ns`` stamps already taken (a queue wait
  that begins on one thread and ends on another);
- ``count(name, n)`` adds to a counter (bytes moved, slots developed).

The log's times are on the clock of ``torch.profiler``'s traces
(Unix-epoch nanoseconds): the recorder takes one ``(time.time_ns(),
time.perf_counter_ns())`` anchor when it is made and converts every
``perf_counter_ns`` stamp by it, so a span log and a profiler trace of
the same run line up. ``chrome_trace()`` writes the log as a Chrome
trace (the CLI's ``export --trace-out``).

A span made with ``profiler=True`` also enters
``torch.profiler.record_function(name)`` when the recorder was made with
``profiler=True`` (a profiler open on the thread that makes it; the
profiler records ranges of that thread only). Only spans that launch
no device work take it: a range around kernel launches becomes a
``gpu_user_annotation`` on the device's timeline, which a trace reader
would count as device time.

``LatencyStats`` keeps the interactive session's tick latencies (the
``stats`` verb's percentiles).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class _Span:
    """One timed block of a ``StageTimer`` (its ``span``): ``start_ns``
    and ``end_ns`` are ``perf_counter_ns`` stamps, readable after the
    block."""

    __slots__ = ("rec", "name", "image", "batch", "parent", "range",
                 "start_ns", "end_ns")

    def __init__(self, rec, name, image, batch, parent, rng):
        self.rec, self.name = rec, name
        self.image, self.batch, self.parent = image, batch, parent
        self.range = rng
        self.start_ns = self.end_ns = 0

    # The stamps are taken while this thread holds the interpreter lock,
    # next to the profiler's own: its range's enter and exit release the
    # lock inside, and a stamp taken after one of them would wait for
    # other threads to hand the lock back.
    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.interval(self.name, self.start_ns, self.end_ns, self.image,
                          self.batch, self.parent)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class StageTimer:
    """Thread-safe totals, counts and counters of named spans, and the
    span log when ``keep_log`` (see the module's docstring)."""

    def __init__(self, keep_log: bool = False, profiler: bool = False):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.log: Optional[List[dict]] = [] if keep_log else None
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self._record_function = None
        if profiler:
            from torch.profiler import record_function

            # A process's first range pays a one-off cost after the
            # profiler's start stamp (about a millisecond); an empty one
            # here keeps it out of the spans' ranges.
            with record_function("StageTimer"):
                pass
            self._record_function = record_function

    def span(self, name: str, image=None, batch=None, parent=None,
             profiler: bool = False) -> _Span:
        rng = (self._record_function(name)
               if profiler and self._record_function is not None else None)
        return _Span(self, name, image, batch, parent, rng)

    def interval(self, name: str, start_ns: int, end_ns: int, image=None,
                 batch=None, parent=None) -> None:
        """A span from two ``perf_counter_ns`` stamps."""
        with self._lock:
            self.totals[name] += (end_ns - start_ns) / 1e9
            self.counts[name] += 1
            if self.log is not None:
                thread = threading.current_thread()
                self.log.append({
                    "name": name, "start_ns": self.epoch_ns(start_ns),
                    "end_ns": self.epoch_ns(end_ns),
                    "tid": thread.native_id, "thread": thread.name,
                    "image": image, "batch": batch, "parent": parent})

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += int(n)

    def epoch_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` stamp on the profiler's clock."""
        return self.anchor[0] + perf_ns - self.anchor[1]

    def report(self) -> dict:
        """``{"spans": {name: {"total_s", "count"}}, "counters": {name:
        n}}``, names sorted."""
        with self._lock:
            return {
                "spans": {name: {"total_s": round(self.totals[name], 6),
                                 "count": self.counts[name]}
                          for name in sorted(self.totals)},
                "counters": {name: self.counters[name]
                             for name in sorted(self.counters)},
            }

    def chrome_trace(self) -> dict:
        """The span log as a Chrome trace (``chrome://tracing``,
        Perfetto): one complete event a span, microseconds on the
        profiler's clock, the thread as ``tid``, the image, flush and
        parent in ``args``."""
        with self._lock:
            log = list(self.log or ())
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                   "args": {"name": name}}
                  for tid, name in sorted({(e["tid"], e["thread"])
                                           for e in log})]
        for e in log:
            args = {k: e[k] for k in ("image", "batch", "parent")
                    if e[k] is not None}
            events.append({"name": e["name"], "ph": "X", "pid": 0,
                           "tid": e["tid"], "ts": e["start_ns"] / 1e3,
                           "dur": (e["end_ns"] - e["start_ns"]) / 1e3,
                           "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class LatencyStats:
    """Rolling latency samples with percentile summary."""

    def __init__(self, max_samples: int = 10_000):
        self.samples: List[float] = []
        self.max_samples = max_samples

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
