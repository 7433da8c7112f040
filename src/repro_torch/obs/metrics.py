"""Metrics — a small registry of counters, gauges and histograms.

The tracer (obs/trace.py) answers "where did the time go"; the metrics
registry answers "how often / how much" for the signals the repro
already produces but only exposes as scattered attributes: executable
cache misses (`GroupPool.stats`), plan-cache hits/misses
(`PlanCache.stats`), KV-cache page occupancy. `ServingEngine` owns a
`MetricsRegistry` and folds those signals in at the end of a run, so one
`snapshot()` at any point gives the whole picture.

Semantics:
  * Counter   — monotonically increasing (`inc`).
  * Gauge     — last-write-wins (`set`).
  * Histogram — `observe(v)` accumulates count/sum/min/max plus a
    bounded reservoir of recent samples for the median; snapshots are
    dicts.

Thread-safe (a single registry lock — these are cold-path updates, at
most a few per scheduled step) and stdlib-only, like the rest of
`repro_torch.obs`.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Union

Scalar = Union[int, float]


class Counter:
    """Monotonic counter."""

    kind = "counter"
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: Scalar = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._lock:
            self.value += n

    def snapshot(self) -> Scalar:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: Scalar) -> None:
        self.value = float(v)

    def snapshot(self) -> Scalar:
        return self.value


class Histogram:
    """Streaming distribution: exact count/sum/min/max + a bounded
    reservoir of the most recent samples for the median."""

    kind = "histogram"
    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "_lock")

    def __init__(self, name: str, reservoir: int = 512):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: "deque[float]" = deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, v: Scalar) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._samples.append(v)

    def snapshot(self) -> Dict[str, Scalar]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0, "p50": 0.0}
            samples = sorted(self._samples)
        p50 = samples[min(len(samples) - 1,
                          int(0.5 * (len(samples) - 1) + 0.5))]
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min, "max": self.max, "p50": p50}


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    Re-requesting a name returns the SAME instrument (so call sites
    don't need to share handles); requesting an existing name as a
    different kind is a bug and raises.
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, reservoir: int = 512) -> Histogram:
        return self._get(name, Histogram, reservoir=reservoir)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time values: scalars for counters/gauges, summary
        dicts for histograms. JSON-serializable."""
        with self._lock:
            instruments = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in
                sorted(instruments)}

    def update_from(self, stats: Dict[str, Scalar], prefix: str = ""
                    ) -> None:
        """Fold a plain stats dict (e.g. `PlanCache.stats`,
        `PoolStats.__dict__`) into gauges named `prefix + key`."""
        for key, value in stats.items():
            if isinstance(value, (int, float)):
                self.gauge(prefix + key).set(value)
