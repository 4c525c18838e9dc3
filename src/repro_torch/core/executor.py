"""One worker loop over a FIFO mailbox — the dispatch engine the decode
scheduler runs on.

Counterpart of ``repro.core.executor``, which is free of JAX by design
(DESIGN.md §1), cut to what ``serve.batcher.DecodeScheduler`` uses:

  * one long-lived **worker thread** runs submitted calls in send order
    and resolves (or rejects) each call's ``PFuture``;
  * **drain / graceful shutdown**: ``drain()`` waits for quiescence;
    ``shutdown()`` finishes in-flight work, stops the loop, and rejects
    anything left so no waiter hangs.

The reference's per-device queues, shared lightweight pool, device
residency hook, backpressure and context switch on wait come back with the
actor-messaging slice.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..obs import clock
from .messages import PFuture


class Executor:
    def __init__(self):
        self._cond = threading.Condition()
        self._mailbox: deque = deque()   # (fn, args, kwargs, future)
        self._inflight = 0               # queued or running
        self._closed = False
        self._stop = False
        self._thread = threading.Thread(target=self._worker, name="push-dev0",
                                        daemon=True)
        self._thread.start()

    def submit(self, fn: Callable, args=(), kwargs=None) -> PFuture:
        fut = PFuture()
        with self._cond:
            if self._closed:
                raise RuntimeError("executor is shut down")
            self._mailbox.append((fn, args, kwargs or {}, fut))
            self._inflight += 1
            self._cond.notify_all()
        return fut

    def _worker(self):
        while True:
            with self._cond:
                while not self._mailbox and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                fn, args, kwargs, fut = self._mailbox.popleft()
            try:
                fut._resolve(fn(*args, **kwargs))
            except BaseException as e:  # surfaced on wait()
                fut._reject(e)
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None):
        """Block until every submitted call has finished running."""
        deadline = None if timeout is None else clock.now() + timeout
        with self._cond:
            while self._inflight > 0:
                rem = None if deadline is None else deadline - clock.now()
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"drain timed out with {self._inflight} in flight")
                self._cond.wait(rem)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop accepting work; finish (or reject) the rest; join the worker."""
        with self._cond:
            self._closed = True
        if drain:
            try:
                self.drain(timeout)
            except TimeoutError:
                pass
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        with self._cond:
            leftovers = list(self._mailbox)
            self._mailbox.clear()
            self._inflight -= len(leftovers)
            self._cond.notify_all()
        for *_, fut in leftovers:
            fut._reject(RuntimeError("executor shut down"))
