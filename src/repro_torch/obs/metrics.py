"""obs.metrics — typed metric registry (Counter / Gauge / Histogram); the
port's copy of ``repro.obs.metrics``, which it may not import.

Native metrics for a latency distribution or a monotonically
increasing count, plus pull collectors that surface existing stats dicts
at export time. ``percentile`` is the one implementation behind every
``latency_p*`` stats key (``serve.service.percentile`` delegates to it).

Histograms keep a bounded ring of raw observations (default 4096) so
percentiles are exact over the recent window, plus lifetime count/sum.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

DEFAULT_RING = 4096


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (``np.percentile`` semantics; q in
    [0, 100]); 0.0 on empty input. The single implementation behind
    every latency_p* stats key in the repo."""
    xs = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


class _Metric:
    __slots__ = ("name", "labels")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels


class Counter(_Metric):
    kind = "counter"
    __slots__ = ("_v",)

    def __init__(self, name: str, labels=()):
        super().__init__(name, labels)
        self._v = 0

    def inc(self, n: int = 1):
        self._v += n

    @property
    def value(self):
        return self._v


class Gauge(_Metric):
    kind = "gauge"
    __slots__ = ("_v", "_fn")

    def __init__(self, name: str, labels=()):
        super().__init__(name, labels)
        self._v = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float):
        self._v = v

    def set_fn(self, fn: Callable[[], float]):
        """Pull gauge: ``value`` calls ``fn`` at read time."""
        self._fn = fn

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._v


class Histogram(_Metric):
    """Bounded-ring distribution: exact percentiles over the last
    ``ring`` observations, lifetime count/sum. ``observe`` is lock-free
    for the same reason the tracer's record is (bounded-deque append is
    atomic; count/sum are best-effort under concurrent writers, exact
    under the single pump threads that own them here)."""
    kind = "histogram"
    __slots__ = ("_ring", "count", "sum")

    def __init__(self, name: str, labels=(), ring: int = DEFAULT_RING):
        super().__init__(name, labels)
        self._ring: deque = deque(maxlen=ring)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float):
        self._ring.append(v)
        self.count += 1
        self.sum += v

    def values(self) -> List[float]:
        return list(self._ring)

    def percentile(self, q: float) -> float:
        return percentile(list(self._ring), q)

    def snapshot(self) -> Dict[str, float]:
        xs = list(self._ring)
        return {"count": self.count, "sum": self.sum,
                "p50": percentile(xs, 50), "p95": percentile(xs, 95),
                "p99": percentile(xs, 99)}


class Registry:
    """Name+labels -> metric, get-or-create; plus pull collectors that
    surface existing stats dicts at export time without copying them
    into typed metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, _Metric] = {}
        self._collectors: List[Tuple[str, Callable[[], Dict]]] = []

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        key = (name, lab)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, lab, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(lab)} exists as {m.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, ring: int = DEFAULT_RING,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, ring=ring)

    def register_collector(self, prefix: str, fn: Callable[[], Dict]):
        """``fn()`` returns a (possibly nested) dict whose numeric
        leaves are exported as gauges under ``prefix``."""
        with self._lock:
            self._collectors.append((prefix, fn))

    def collect(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def collector_values(self) -> Dict[str, Dict]:
        with self._lock:
            collectors = list(self._collectors)
        out = {}
        for prefix, fn in collectors:
            try:
                out[prefix] = fn()
            except Exception:   # a dead collector must not kill export
                continue
        return out

    def size(self) -> int:
        with self._lock:
            return len(self._metrics)

    def clear(self):
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


REGISTRY = Registry()
