"""Futures and message plumbing for the particle runtime (paper §3.2;
counterpart of ``repro.core.messages``).

``PFuture`` is the handle a particle receives when it ``send``s a message:
the receiver executes the handler on its own timeline; the sender may
``wait()`` (async-await side of the paper's blended concurrency model).

``PFuture.wait`` is runtime-aware: executor worker threads (executor.py)
install a thread-local *wait hook*, so a handler that blocks on another
particle's future context-switches into servicing its device's queue
instead of parking the worker — the paper's §4.2 call-stack context
switch. Threads outside the runtime (the user's main thread) fall back
to a plain event wait. Done-callbacks let the executor wake a waiting
worker the moment a cross-device future resolves.

``ParticleView`` is the result of ``particle.get(pid)...wait().view()``:
a *read-only* snapshot of another particle's parameters (paper §3.2).
Snapshots are decoupled from the owner's live state, so owners can keep
updating concurrently. Unlike JAX arrays, tensors are mutable, and the
store hands out views that a flush or an in-place update rewrites, so
``snapshot`` clones every leaf.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from .tree import tree_map

# Thread-local runtime state. Executor worker threads set
# ``_tls.wait_hook`` to a callable ``hook(future, timeout) -> bool``
# (True = future completed, False = timed out) that runs queued work
# while waiting. See executor.py.
_tls = threading.local()


def current_wait_hook() -> Optional[Callable]:
    return getattr(_tls, "wait_hook", None)


class PFuture:
    """Future for an asynchronously dispatched particle computation."""

    __slots__ = ("_event", "_value", "_exc", "_lock", "_callbacks")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []

    def _fire(self):
        with self._lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb()

    def _resolve(self, value: Any):
        self._value = value
        self._fire()

    def _reject(self, exc: BaseException):
        self._exc = exc
        self._fire()

    def _on_done(self, cb: Callable[[], None]):
        """Run ``cb`` once the future completes (immediately if done)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.is_set():
            hook = current_wait_hook()
            if hook is None:
                if not self._event.wait(timeout):
                    raise TimeoutError("PFuture.wait timed out")
            elif not hook(self, timeout):
                raise TimeoutError("PFuture.wait timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


def resolved(value: Any) -> PFuture:
    f = PFuture()
    f._resolve(value)
    return f


class ParticleView:
    """Read-only snapshot of a particle's parameters (+ optional grads)."""

    __slots__ = ("_params", "_grads", "pid")

    def __init__(self, pid: int, params, grads=None):
        self.pid = pid
        self._params = params
        self._grads = grads

    def view(self) -> "ParticleView":
        return self

    def parameters(self):
        return self._params

    def gradients(self):
        return self._grads


def snapshot(tree):
    """Copy-on-read: a clone of every leaf, enqueued on the current
    stream of the leaf's device (the default stream on the NEL's path,
    so it is ordered after the owner's launches)."""
    return tree_map(lambda x: x.clone(), tree)
