"""Metrics registry: counters, gauges, histograms with bounded reservoirs.

The runtime reports into ONE registry so every exporter (JSONL events,
Prometheus text, the SummaryWriter bridge) sees the same data — the
reference scatters the same facts across ThroughputTimer prints,
TensorBoard scalars, and wall_clock_breakdown logs
(reference: deepspeed/utils/timer.py, runtime/engine.py:977-1030).

Recording is host-only and cheap (a dict update under a lock); nothing
here ever touches a device buffer, which is what lets the engine record
per step without breaking its async-dispatch overlap.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic per-label-set counter (``recompiles_total{program=...}``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def series(self) -> List[Tuple[_LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class Gauge(_Metric):
    """Last-write-wins value (``device_bytes_in_use{device="0"}``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: str):
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))

    def series(self) -> List[Tuple[_LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class _Reservoir:
    """Bounded sample set: exact until ``size`` observations, then
    uniform reservoir sampling (Vitter's algorithm R) — percentiles stay
    O(size) memory over unbounded streams, the property that makes a
    histogram safe to leave enabled for a million-step run."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.samples: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, value: float):
        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if len(self.samples) < self.size:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.size:
                self.samples[j] = value

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * min(max(q, 0.0), 1.0)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac


class Histogram(_Metric):
    """Distribution with a bounded reservoir per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", reservoir_size: int = 2048):
        super().__init__(name, help)
        self.reservoir_size = reservoir_size
        self._series: Dict[_LabelKey, _Reservoir] = {}

    def observe(self, value: float, **labels: str):
        key = _label_key(labels)
        with self._lock:
            res = self._series.get(key)
            if res is None:
                res = self._series[key] = _Reservoir(
                    self.reservoir_size, seed=hash(key) & 0xFFFF)
            res.observe(value)

    def reservoir(self, **labels: str) -> Optional[_Reservoir]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def series(self) -> List[Tuple[_LabelKey, _Reservoir]]:
        with self._lock:
            return sorted(self._series.items(), key=lambda kv: kv[0])


class MetricsRegistry:
    """Named metrics, created idempotently (the engine, the compile
    monitor, and user code can all ask for the same counter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  reservoir_size: int = 2048) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   reservoir_size=reservoir_size)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> List[dict]:
        """Plain-data view of every metric (the JSONL exporter's unit)."""
        out: List[dict] = []
        for m in self.metrics():
            if isinstance(m, (Counter, Gauge)):
                for key, v in m.series():
                    out.append({"name": m.name, "kind": m.kind,
                                "labels": dict(key), "value": v})
            elif isinstance(m, Histogram):
                for key, res in m.series():
                    out.append({
                        "name": m.name, "kind": m.kind,
                        "labels": dict(key),
                        "count": res.count, "sum": res.total,
                        "min": res.min, "max": res.max,
                        "p50": res.percentile(0.50),
                        "p95": res.percentile(0.95),
                        "p99": res.percentile(0.99),
                    })
        return out
