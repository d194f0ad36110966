"""Metrics registry: counters / gauges / histograms with a JSONL sink
(DESIGN.md §13).

Host-side only — instruments NEVER touch traced values.  The drivers
observe already-materialized host scalars/arrays (loss means, β vectors,
store byte counters), so recording is a pure read of numbers the run
produced anyway; with observability off the registry object simply never
exists and nothing is written (the zero-overhead contract).

``flush(step)`` appends one snapshot line per applied server update to
``metrics.jsonl``; the file is opened in append mode so a resumed run
continues the same series (the trace-side ``resume`` marker carries the
cut point).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram; right-open buckets.

    ``edges`` are ascending bucket boundaries: counts[0] holds x <
    edges[0], counts[i] holds edges[i-1] <= x < edges[i], counts[-1]
    holds x >= edges[-1] (len(counts) == len(edges) + 1).  Accepts
    scalars or arrays; accumulates count/sum/min/max alongside.
    """

    def __init__(self, edges: Sequence[float]):
        self.edges = [float(e) for e in edges]
        if self.edges != sorted(self.edges) or len(self.edges) < 1:
            raise ValueError(f"histogram edges must be ascending, got {edges}")
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, x) -> None:
        arr = np.asarray(x, np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.edges, arr, side="right")
        for i, n in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(i)] += int(n)
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        lo, hi = float(arr.min()), float(arr.max())
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def snapshot(self) -> dict:
        return {
            "edges": self.edges, "counts": list(self.counts),
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
        }


class MetricsRegistry:
    """Named counters/gauges/histograms + JSONL snapshot sink."""

    def __init__(self, path=None):
        self._path = Path(path) if path else None
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._f = None
        if self._path is not None:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self._path, "a")

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, edges: Sequence[float]) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(edges)
        return h

    def set_gauges(self, prefix: str, values: dict) -> None:
        """Mirror a flat numeric dict (e.g. ``CohortStore.stats()``) into
        ``prefix.key`` gauges; non-numeric values are skipped."""
        for key, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(f"{prefix}.{key}").set(v)

    def snapshot(self) -> dict:
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.snapshot()
                           for n, h in self._histograms.items()},
        }

    def flush(self, step=None, **extra) -> None:
        """Append one snapshot line (no-op without a sink path)."""
        if self._f is None:
            return
        line = {"step": step, **extra, **self.snapshot()}
        self._f.write(json.dumps(line) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_metrics(path) -> List[dict]:
    """Parse a metrics.jsonl file back into snapshot dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
