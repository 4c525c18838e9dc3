"""Observability for the port (counterpart of ``repro.obs``).

clock.py   -- the one timebase (perf_counter) every subsystem stamps
trace.py   -- thread-safe bounded-ring span recorder, a no-op when
              disabled; instruments executor / store / runtime / serve /
              decode / bdl (span taxonomy: DESIGN.md §12)
metrics.py -- Counter / Gauge / Histogram registry and ``percentile``
device.py  -- per-device memory gauges, store / page-pool occupancy,
              per-Program FLOPs / bytes cost attribution, counted on each
              program's first run
export.py  -- Chrome/Perfetto trace-event JSON and Prometheus text

``summary()`` is the ``stats()["obs"]`` section; ``Obs`` is the
``pd.obs()`` front-end.
"""
from typing import Any, Dict

from . import clock, device, export, metrics, trace


def summary() -> Dict[str, Any]:
    """The ``pd.stats()["obs"]`` section: tracer + registry state."""
    c = trace.TRACER.counts()
    return {
        "tracing_enabled": trace.TRACER.enabled,
        "spans_recorded": c["recorded"],
        "spans_buffered": c["buffered"],
        "spans_dropped": c["dropped"],
        "ring": trace.TRACER.ring,
        "clock": "perf_counter",
        "metrics": metrics.REGISTRY.size(),
    }


class Obs:
    """``pd.obs()`` front-end: one handle for snapshot / dump / export.

        pd.obs().snapshot()             # stats + devices + program costs
        pd.obs().dump_trace("t.json")   # open at ui.perfetto.dev
        pd.obs().prometheus()           # text exposition for a scrape
    """

    def __init__(self, pd):
        self.pd = pd

    def snapshot(self, *, costs: bool = False) -> Dict[str, Any]:
        """Everything at once: the unified stats dict, device gauges,
        store occupancy, per-program cost attribution (``costs=True``
        assembles the cost of every program that has run; without it only
        costs already asked for appear) and the tracer's counters."""
        return {
            "stats": self.pd.stats(),
            "devices": device.device_gauges(
                self.pd.store.devices() + list(self.pd.nel.devices)),
            "store": device.store_gauges(self.pd.store),
            "programs": self.pd.runtime.cache.program_costs(compute=costs),
            "trace": trace.TRACER.counts(),
        }

    def chrome_trace(self) -> Dict[str, Any]:
        return export.chrome_trace()

    def dump_trace(self, path: str) -> str:
        return export.dump_chrome_trace(path)

    def prometheus(self) -> str:
        return export.prometheus_text(extra=self.pd.stats())
