"""obs.trace — thread-safe span recorder (DESIGN.md §12); the port's copy
of ``repro.obs.trace``, which it may not import.

One process-wide ``Tracer`` holds a bounded ring of completed spans.
The design constraints come from the executor's dispatch loop, which
runs ~10µs work items:

  * **compiled-out when disabled** — every instrumentation site guards
    on ``TRACER.enabled`` (one attribute load + branch); ``span()``
    returns a shared no-op context manager, allocating nothing.
  * **lock-free record** — a ``deque(maxlen=N)`` append is atomic under
    the GIL, so the hot path takes NO lock and old spans fall off the
    far end instead of blocking; only ``snapshot``/``clear`` and ring
    resizing serialize.
  * **per-thread track ids** — spans carry ``threading.get_ident()``;
    long-lived workers register a human name via ``name_track`` so the
    exporter can label Perfetto tracks ("push-dev0", "MainThread").

Spans nest naturally: a span records on *exit*, and Chrome trace-event
viewers reconstruct nesting from (tid, ts, dur) containment — no parent
pointers needed.

Span taxonomy: DESIGN.md §12. In the port only the executor records
spans so far (``executor.run``, ``executor.mailbox_wait``, cat
``executor``).
"""
from __future__ import annotations

import functools
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from . import clock

_DEFAULT_RING = 65536


class Tracer:
    def __init__(self, ring: int = _DEFAULT_RING):
        self.enabled = False
        self._lock = threading.Lock()
        # entries: (name, cat, t0, t1, tid, args-or-None)
        self._buf: deque = deque(maxlen=ring)
        self._recorded = 0
        self._tracks: Dict[int, str] = {}

    @property
    def ring(self) -> int:
        return self._buf.maxlen

    # -- lifecycle -----------------------------------------------------------
    def enable(self, ring: Optional[int] = None):
        with self._lock:
            if ring is not None and ring != self._buf.maxlen:
                self._buf = deque(self._buf, maxlen=ring)
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._recorded = 0

    # -- the hot path --------------------------------------------------------
    def record(self, name: str, cat: str, t0: float, t1: float,
               args: Optional[dict] = None, tid: Optional[int] = None):
        """Append one completed span. Lock-free: bounded-deque append is
        atomic; ``_recorded`` is a best-effort counter (exact under any
        single recording thread, which is what the ring-bound test and
        the drop accounting care about)."""
        if tid is None:
            tid = threading.get_ident()
        self._buf.append((name, cat, t0, t1, tid, args))
        self._recorded += 1

    def instant(self, name: str, cat: str = "event", **args):
        """Zero-duration point event (exported as a Perfetto instant)."""
        if self.enabled:
            t = clock.now()
            self.record(name, cat, t, t, args or None)

    # -- track naming --------------------------------------------------------
    def name_track(self, name: str, tid: Optional[int] = None):
        with self._lock:
            self._tracks[tid if tid is not None
                         else threading.get_ident()] = name

    def track_names(self) -> Dict[int, str]:
        """{tid: name} for every known track — explicit registrations
        first, live threads (by their Python name) as fallback."""
        with self._lock:
            names = dict(self._tracks)
        for t in threading.enumerate():
            if t.ident is not None:
                names.setdefault(t.ident, t.name)
        return names

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._buf)
        return [{"name": n, "cat": c, "t0": t0, "t1": t1, "tid": tid,
                 "args": dict(args) if args else {}}
                for (n, c, t0, t1, tid, args) in entries]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            buffered = len(self._buf)
            recorded = self._recorded
        return {"recorded": recorded, "buffered": buffered,
                "dropped": max(0, recorded - buffered)}


TRACER = Tracer()


# ---------------------------------------------------------------------------
# module-level front-end (what instrumentation sites import)
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Shared do-nothing context manager: the disabled path allocates
    nothing and its __enter__/__exit__ are empty-body calls."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = clock.now()
        return self

    def __exit__(self, *exc):
        TRACER.record(self.name, self.cat, self.t0, clock.now(), self.args)
        return False


def span(name: str, cat: str = "span", **args):
    """``with span("store.commit", "store", key=key): ...`` — records a
    complete span on exit; a shared no-op when tracing is disabled."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(name, cat, args or None)


def traced(name: Optional[str] = None, cat: str = "fn"):
    """Decorator form of ``span`` (label defaults to the qualname)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled:
                return fn(*a, **kw)
            with _Span(label, cat, None):
                return fn(*a, **kw)
        return wrapper
    return deco


def instant(name: str, cat: str = "event", **args):
    TRACER.instant(name, cat, **args)


def enabled() -> bool:
    return TRACER.enabled


def enable(ring: Optional[int] = None):
    TRACER.enable(ring)


def disable():
    TRACER.disable()


def clear():
    TRACER.clear()


def snapshot() -> List[Dict[str, Any]]:
    return TRACER.snapshot()
