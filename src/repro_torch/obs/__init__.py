"""Observability for the port (counterpart of ``repro.obs``).

clock.py   -- the one timebase (perf_counter) every subsystem stamps
trace.py   -- thread-safe bounded-ring span recorder, a no-op when
              disabled; the executor records ``executor.run`` and
              ``executor.mailbox_wait`` spans through it
metrics.py -- Counter / Gauge / Histogram registry and ``percentile``

``summary()`` is the ``stats()["obs"]`` section. The reference's ``Obs``
front-end, ``device.py`` and ``export.py`` are not ported yet.
"""
from typing import Any, Dict

from . import clock, metrics, trace


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
