"""Futures for the particle runtime (counterpart of
``repro.core.messages``; the actor-messaging views and the executor's
context switch on wait come with a later slice).

``PFuture`` is the handle a dispatched computation returns: the executor
resolves or rejects it, and ``wait`` blocks the caller until then.
"""
from __future__ import annotations

import threading
from typing import Any, Optional


class PFuture:
    """Future for an asynchronously dispatched computation."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def _resolve(self, value: Any):
        self._value = value
        self._event.set()

    def _reject(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("PFuture.wait timed out")
        if self._exc is not None:
            raise self._exc
        return self._value
