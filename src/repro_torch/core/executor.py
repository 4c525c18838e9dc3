"""Persistent per-device event loops (paper §4.2) — the dispatch engine
(counterpart of ``repro.core.executor``, which the port may not import).

The paper's scheduler shape:

  * one long-lived **worker loop per device**. All device-bound work for
    a particle flows through the particle's **FIFO mailbox**; the worker
    round-robins over mailboxes that have pending messages, so messages
    to one particle execute in send order while distinct particles on
    the same device interleave fairly. A single worker per device also
    *is* the device serialization: no per-device lock is needed.
  * a small **shared pool** for lightweight lock-free state reads
    (``get``/views, paper §4.2's "same-device communication can be
    eliminated") that must not queue behind device compute.
  * **context switching on wait**: a handler that blocks on another
    particle's ``PFuture`` does not park its worker — ``PFuture.wait``
    calls back into the executor (via a thread-local hook, see
    messages.py) and the worker services its queue until the future
    resolves. This is the paper's call-stack context switch and is what
    lets nested send-and-wait chains run on a fixed thread count.
  * **bounded queues**: each device queue admits at most
    ``max_pending`` outstanding messages; submitters outside the
    runtime block (backpressure) instead of growing memory without
    bound. Executor threads are exempt so helping can never deadlock.
  * **drain / graceful shutdown**: ``drain()`` waits for quiescence;
    ``shutdown()`` finishes in-flight work, stops the loops, and
    rejects anything left so no waiter hangs.

Dispatch statistics record counts, queue depths and wait-vs-run time —
the quantities §5's scaling discussion reasons about. When ``obs.trace``
is enabled, every run item additionally lands as an ``executor.run``
span (with its mailbox-wait time) and every context-switched wait as
``executor.mailbox_wait`` — timeline views of the same quantities. All
timing goes through ``obs.clock`` (one timebase with the serving layer).

The executor holds no device state: device residency (and, on the card,
the worker's current CUDA device) is injected by the NEL as a
``device_prep(dev_idx, pid)`` callback, so the scheduler is testable
with plain Python callables (tests/test_torch_executor.py).

Unlike the reference, the workers start on the first ``submit``, not at
construction: every PushDistribution owns a NEL, and one that only
serves or runs fused programs then holds no thread at all.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..obs import clock
from ..obs import trace as _trace
from . import messages
from .messages import PFuture


class _WorkItem:
    __slots__ = ("pid", "fn", "args", "kwargs", "future", "needs_device",
                 "t_enqueue")

    def __init__(self, pid, fn, args, kwargs, future, needs_device):
        self.pid = pid
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.future = future
        self.needs_device = needs_device
        self.t_enqueue = clock.now()


class _Mailbox:
    """FIFO message buffer for one particle (or one anonymous pool item)."""

    __slots__ = ("pid", "items", "scheduled")

    def __init__(self, pid: Optional[int] = None):
        self.pid = pid
        self.items: deque = deque()
        self.scheduled = False  # currently linked into its queue's ready list


class _Queue:
    """Run queue for one worker group: mailboxes with pending messages."""

    __slots__ = ("index", "cond", "ready", "pending", "max_depth")

    def __init__(self, index: int):
        self.index = index
        self.cond = threading.Condition()
        self.ready: deque = deque()     # mailboxes with >= 1 message
        self.pending = 0                # messages enqueued or running
        self.max_depth = 0


_POOL_QUEUE = -1  # queue index for the shared lightweight pool


class Executor:
    def __init__(self, num_devices: int, *,
                 device_prep: Optional[Callable[[int, int], None]] = None,
                 pool_size: Optional[int] = None,
                 max_pending: int = 4096):
        if num_devices < 1:
            raise ValueError("need at least one device worker")
        self.num_devices = num_devices
        self.max_pending = max_pending
        self._device_prep = device_prep
        self._queues = [_Queue(i) for i in range(num_devices)]
        self._pool_queue = _Queue(_POOL_QUEUE)
        self._mailboxes: Dict[int, _Mailbox] = {}
        self._device_of: Dict[int, int] = {}
        self._closed = False
        self._stop = False
        self._idle = threading.Condition()
        self._inflight = 0
        self._stats_lock = threading.Lock()
        self._tlocal = threading.local()  # nested-run accounting per thread
        self._dispatched = 0
        self._completed = 0
        self._pool_dispatched = 0
        self._wait_s = 0.0
        self._run_s = 0.0

        self._threads: List[threading.Thread] = []
        for i, q in enumerate(self._queues):
            t = threading.Thread(target=self._worker, args=(q,),
                                 name=f"push-dev{i}", daemon=True)
            self._threads.append(t)
        if pool_size is None:
            pool_size = max(2, min(8, 2 * num_devices))
        for i in range(pool_size):
            t = threading.Thread(target=self._worker, args=(self._pool_queue,),
                                 name=f"push-pool{i}", daemon=True)
            self._threads.append(t)
        self._started = False
        self._start_lock = threading.Lock()

    def _start(self):
        with self._start_lock:
            if not self._started:
                for t in self._threads:
                    t.start()
                self._started = True

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def add_particle(self, pid: int, device_idx: int):
        q = self._queues[device_idx]
        with q.cond:
            self._mailboxes[pid] = _Mailbox(pid)
            self._device_of[pid] = device_idx

    def remove_particle(self, pid: int):
        """Drop a retired particle's mailbox and device entry. Messages
        already scheduled keep running (the ready list holds the mailbox
        reference), but no new work can be submitted for the pid."""
        dev = self._device_of.pop(pid, None)
        if dev is None:
            return
        q = self._queues[dev]
        with q.cond:
            self._mailboxes.pop(pid, None)

    def move_particle(self, pid: int, device_idx: int):
        """Reassign a particle's mailbox to another device worker. The
        caller must have drained the runtime first (NodeEventLoop
        .rebalance does) — a scheduled mailbox cannot be moved."""
        old = self._device_of.get(pid)
        if old is None or old == device_idx:
            self._device_of[pid] = device_idx
            return
        with self._queues[old].cond:
            mb = self._mailboxes.get(pid)
            if mb is not None and (mb.scheduled or mb.items):
                raise RuntimeError(
                    f"cannot move particle {pid}: mailbox busy (drain first)")
            self._device_of[pid] = device_idx

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, pid: int, fn: Callable, args=(), kwargs=None, *,
               needs_device: bool = False, lightweight: bool = False) -> PFuture:
        if not self._started:
            self._start()
        fut = PFuture()
        item = _WorkItem(pid, fn, args, kwargs or {}, fut, needs_device)
        if lightweight:
            q, mb = self._pool_queue, _Mailbox(pid)
        else:
            q, mb = self._queues[self._device_of[pid]], self._mailboxes[pid]
        in_runtime = messages.current_wait_hook() is not None
        with q.cond:
            # After close, external submitters are rejected; runtime threads
            # may still enqueue nested work so in-flight handlers can finish
            # during the drain phase. Once loops stop, everyone is rejected.
            if self._stop or (self._closed and not in_runtime):
                raise RuntimeError("executor is shut down")
            # Backpressure: external submitters block while the device queue
            # is full. Runtime threads are exempt — blocking a worker on its
            # own (or a sibling's) full queue could deadlock the loop.
            while (not in_runtime and self.max_pending
                   and q.pending >= self.max_pending):
                q.cond.wait(0.05)
                if self._closed:
                    raise RuntimeError("executor is shut down")
            with self._idle:
                self._inflight += 1
            q.pending += 1
            if q.pending > q.max_depth:
                q.max_depth = q.pending
            mb.items.append(item)
            if not mb.scheduled:
                mb.scheduled = True
                q.ready.append(mb)
            q.cond.notify()
        with self._stats_lock:
            self._dispatched += 1
            if lightweight:
                self._pool_dispatched += 1
        return fut

    # ------------------------------------------------------------------
    # worker machinery
    # ------------------------------------------------------------------
    def _pop(self, q: _Queue, timeout: float) -> Optional[_WorkItem]:
        with q.cond:
            if not q.ready:
                q.cond.wait(timeout)
            if not q.ready:
                return None
            mb = q.ready.popleft()
            item = mb.items.popleft()
            if mb.items:
                q.ready.append(mb)   # round-robin across particles
            else:
                mb.scheduled = False
            return item

    def _run_item(self, q: _Queue, item: _WorkItem):
        t0 = clock.now()
        # nested accounting: items run by the wait hook *inside* this item's
        # span charge their wall time to our `nested_s`, and we subtract it,
        # so run_time_s never double-counts context-switched work
        outer_nested = getattr(self._tlocal, "nested_s", 0.0)
        self._tlocal.nested_s = 0.0
        value, exc = None, None
        try:
            if item.needs_device and self._device_prep is not None:
                self._device_prep(q.index, item.pid)
            value = item.fn(*item.args, **item.kwargs)
        except BaseException as e:  # surfaced on wait()
            exc = e
        t1 = clock.now()
        span = t1 - t0
        inner = self._tlocal.nested_s
        self._tlocal.nested_s = outer_nested + span
        tr = _trace.TRACER
        if tr.enabled:
            # inlined Tracer.record (~10µs work items make a method call
            # + get_ident measurable; the tid is cached per worker
            # thread, the deque append is GIL-atomic)
            tid = getattr(self._tlocal, "tid", None)
            if tid is None:
                tid = self._tlocal.tid = threading.get_ident()
            tr._buf.append(("executor.run", "executor", t0, t1, tid,
                            {"pid": item.pid, "queue": q.index,
                             "wait_ms": (t0 - item.t_enqueue) * 1e3}))
            tr._recorded += 1
        with q.cond:
            q.pending -= 1
            q.cond.notify_all()
        with self._stats_lock:
            self._completed += 1
            self._wait_s += t0 - item.t_enqueue
            self._run_s += span - inner
        # the future completes once the stats count the item (a waiter
        # that wakes on it reads them whole), and before drain() can
        # return
        if exc is None:
            item.future._resolve(value)
        else:
            item.future._reject(exc)
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    def _make_wait_hook(self, q: _Queue):
        """Context switch: run queued work while a future is outstanding."""

        def wait_loop(fut: PFuture, timeout: Optional[float]) -> bool:
            deadline = None if timeout is None else clock.now() + timeout

            def wake():
                with q.cond:
                    q.cond.notify_all()

            fut._on_done(wake)
            while not fut.done():
                if self._stop:
                    rem = (None if deadline is None
                           else max(0.0, deadline - clock.now()))
                    return fut._event.wait(rem)
                # deadline is re-checked every iteration — including right
                # after running an item — so a busy queue cannot starve the
                # caller's timeout indefinitely
                if deadline is not None and clock.now() >= deadline:
                    return fut.done()
                rem = 0.1
                if deadline is not None:
                    rem = min(rem, max(0.0, deadline - clock.now()))
                item = self._pop(q, rem)
                if item is not None:
                    self._run_item(q, item)
            return True

        def hook(fut: PFuture, timeout: Optional[float]) -> bool:
            tr = _trace.TRACER
            if not tr.enabled:
                return wait_loop(fut, timeout)
            t0 = clock.now()
            try:
                return wait_loop(fut, timeout)
            finally:
                tr.record("executor.mailbox_wait", "executor", t0,
                          clock.now(), {"queue": q.index})

        return hook

    def _worker(self, q: _Queue):
        _trace.TRACER.name_track(threading.current_thread().name)
        messages._tls.wait_hook = self._make_wait_hook(q)
        while not self._stop:
            item = self._pop(q, 0.1)
            if item is not None:
                self._run_item(q, item)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def drain(self, timeout: Optional[float] = None):
        """Block until every submitted message has finished running."""
        deadline = None if timeout is None else clock.now() + timeout
        with self._idle:
            while self._inflight > 0:
                rem = 1.0
                if deadline is not None:
                    rem = deadline - clock.now()
                    if rem <= 0:
                        raise TimeoutError(
                            f"drain timed out with {self._inflight} in flight")
                self._idle.wait(rem)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop accepting work; finish (or reject) the rest; join workers.
        Once the loops are told to stop, a worker finishes the item it
        is running and takes no other (the reference's workers empty
        their queues first), so ``drain=False`` rejects what is queued."""
        for q in self._all_queues():
            with q.cond:
                self._closed = True
                q.cond.notify_all()
        if drain:
            try:
                self.drain(timeout)
            except TimeoutError:
                pass
        self._stop = True
        for q in self._all_queues():
            with q.cond:
                q.cond.notify_all()
        with self._start_lock:
            started, self._started = self._started, True   # none start now
        for t in self._threads if started else ():
            t.join(timeout=timeout)
        # reject whatever is left so no waiter hangs forever
        for q in self._all_queues():
            leftovers = []
            with q.cond:
                while q.ready:
                    mb = q.ready.popleft()
                    leftovers.extend(mb.items)
                    mb.items.clear()
                    mb.scheduled = False
                q.pending -= len(leftovers)
            for item in leftovers:
                item.future._reject(RuntimeError("executor shut down"))
                with self._idle:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

    def _all_queues(self):
        return self._queues + [self._pool_queue]

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def num_threads(self) -> int:
        return len(self._threads)

    def queue_depths(self) -> List[int]:
        return [q.pending for q in self._queues]

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {
                "dispatched": self._dispatched,
                "completed": self._completed,
                "pool_dispatched": self._pool_dispatched,
                "queue_depths": self.queue_depths(),
                "pool_depth": self._pool_queue.pending,
                "max_queue_depth": max(q.max_depth for q in self._all_queues()),
                "wait_time_s": self._wait_s,
                "run_time_s": self._run_s,
                "threads": len(self._threads),
            }
