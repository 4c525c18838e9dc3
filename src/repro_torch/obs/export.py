"""obs.export — Chrome/Perfetto trace-event JSON + Prometheus text; the
port's copy of ``repro.obs.export``, which it may not import.

``chrome_trace()`` renders the tracer's ring as the Trace Event Format
(the JSON Perfetto's legacy importer and chrome://tracing both load):
complete events (``ph: "X"``, ``ts``/``dur`` in microseconds since
``clock.EPOCH``) per span, instant events (``ph: "i"``) for
zero-duration marks, and ``thread_name`` metadata events so executor
workers show up as labelled tracks.

``prometheus_text()`` renders the metric registry — typed metrics as
counter/gauge/summary lines, pull collectors (the ``pd.stats()``
sections) flattened to gauges — in the text exposition format a
Prometheus scrape endpoint would serve.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

from . import clock, metrics, trace

# ---------------------------------------------------------------------------
# Chrome / Perfetto trace-event JSON
# ---------------------------------------------------------------------------


def chrome_trace(spans: Optional[List[Dict[str, Any]]] = None,
                 track_names: Optional[Dict[int, str]] = None
                 ) -> Dict[str, Any]:
    """The current tracer ring (or an explicit span list) as a
    trace-event JSON object."""
    if spans is None:
        spans = trace.TRACER.snapshot()
    if track_names is None:
        track_names = trace.TRACER.track_names()
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    tids = {s["tid"] for s in spans}
    for tid in sorted(tids):
        name = track_names.get(tid)
        if name:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
    for s in spans:
        ev: Dict[str, Any] = {"name": s["name"], "cat": s["cat"],
                              "pid": pid, "tid": s["tid"],
                              "ts": round(clock.to_us(s["t0"]), 3)}
        if s["t1"] > s["t0"]:
            ev["ph"] = "X"
            ev["dur"] = round((s["t1"] - s["t0"]) * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"       # thread-scoped instant
        if s["args"]:
            ev["args"] = s["args"]
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path: str,
                      spans: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write ``chrome_trace()`` to ``path``; open it at ui.perfetto.dev."""
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _san(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _labels(lab) -> str:
    if not lab:
        return ""
    inner = ",".join(f'{_san(k)}="{v}"' for k, v in lab)
    return "{" + inner + "}"


def _flatten(prefix: str, obj, out: Dict[str, float]):
    """Numeric leaves of a nested stats dict -> flat metric names."""
    if isinstance(obj, bool):
        out[prefix] = float(obj)
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}_{_san(str(k))}", v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}_{i}", v, out)
    # strings / None / objects are dropped: exposition is numeric


def prometheus_text(registry: Optional[metrics.Registry] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    prefix: str = "repro") -> str:
    """Registry metrics + pull collectors (+ an optional extra nested
    dict, e.g. a ``pd.stats()`` snapshot) in text exposition format."""
    registry = registry if registry is not None else metrics.REGISTRY
    lines: List[str] = []
    for m in registry.collect():
        name = _san(f"{prefix}_{m.name}")
        lab = _labels(m.labels)
        if m.kind == "histogram":
            lines.append(f"# TYPE {name} summary")
            snap = m.snapshot()
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                ql = dict(m.labels) if m.labels else {}
                ql["quantile"] = q
                lines.append(f"{name}{_labels(tuple(ql.items()))} "
                             f"{snap[key]}")
            lines.append(f"{name}_count{lab} {snap['count']}")
            lines.append(f"{name}_sum{lab} {snap['sum']}")
        else:
            lines.append(f"# TYPE {name} {m.kind}")
            lines.append(f"{name}{lab} {float(m.value)}")
    flat: Dict[str, float] = {}
    for cprefix, values in registry.collector_values().items():
        _flatten(f"{prefix}_{_san(cprefix)}", values, flat)
    if extra:
        for k, v in extra.items():
            _flatten(f"{prefix}_{_san(str(k))}", v, flat)
    for name in sorted(flat):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {flat[name]}")
    return "\n".join(lines) + "\n"
