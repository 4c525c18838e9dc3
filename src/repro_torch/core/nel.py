"""Node Event Loop (paper §4.2) — the particle runtime (counterpart of
``repro.core.nel``).

A NEL owns (1) a particle-to-device lookup table, (2) a per-device
*active set* (the particle cache): at most ``cache_size`` particles are
resident per device, the least recently used swapped out first, and (3)
a persistent ``Executor`` — one long-lived worker loop per device plus a
shared lightweight pool (executor.py). ``dispatch`` *enqueues* one hop of
a particle's logical timeline onto its device's loop; no thread is ever
created per message.

  * "device" = a ``torch.device``. On the card the NEL runs one worker
    for ``cuda:0``; each worker makes its device current before a hop
    (``device_prep``), since the current CUDA device is per thread. With
    a CPU store, ``num_devices`` logical workers share the CPU: that is
    how the tests exercise cross-device scheduling, as the reference's
    use forced host devices.
  * *device* work (forward / backward / parameter updates) runs on the
    target device's single worker loop, which serializes compute per
    device while letting different devices progress concurrently (the
    paper's Fig. 3b). Every hop runs on the device's default stream.
  * messages to one particle execute in FIFO send order (per-particle
    mailboxes); distinct particles on a device round-robin.
  * lightweight state reads (``get``/views) run on the shared pool and
    never queue behind device compute.
  * ``send`` returns immediately with a PFuture (async-await).

The port's ParticleStore holds every row of a key in one stacked tensor
on one device, so a particle has no other home: ``num_devices > 1`` on
CUDA and ``offload=True`` raise (ROADMAP.md, queue 1 item 10: multi-GPU
placement). The active set then only keeps the LRU accounting
(``swaps_in`` / ``swaps_out``) that the reference's keeps.

Handlers may freely send-and-wait on other particles: a blocked handler
context-switches its worker into servicing the device queue (the
paper's call-stack context switch — see Executor._make_wait_hook), so a
waiting handler never starves the particle it is waiting on.

Instrumentation (``stats`` + ``executor.stats()``) counts dispatches,
swaps, cross-device transfers, queue depths and wait-vs-run time.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from .executor import Executor
from .messages import PFuture

_ONE_DEVICE = ("the port's ParticleStore keeps every particle on one device; "
               "{what} waits for multi-GPU placement (ROADMAP.md, queue 1 "
               "item 10)")


class NodeEventLoop:
    def __init__(self, num_devices: Optional[int] = None, cache_size: int = 4,
                 offload: bool = False, max_pending: int = 4096,
                 pool_size: Optional[int] = None, device=None):
        device = torch.device("cuda" if device is None else device)
        if num_devices is None:
            num_devices = 1
        if offload:
            raise NotImplementedError(_ONE_DEVICE.format(
                what="offloading particles to the host"))
        if device.type == "cuda":
            if num_devices > 1:
                raise NotImplementedError(_ONE_DEVICE.format(
                    what=f"a NEL over {num_devices} GPUs"))
            present = torch.cuda.device_count()
            if num_devices > present:
                raise ValueError(f"requested {num_devices} devices but only "
                                 f"{present} present")
            index = device.index if device.index is not None else 0
            self.devices = [torch.device("cuda", index)]
        else:
            self.devices = [device] * num_devices   # logical workers
        self.cache_size = cache_size
        self.offload = offload
        # particle-to-device lookup table
        self._device_of: Dict[int, int] = {}
        self._particles: Dict[int, Any] = {}
        # per-device active set (LRU particle cache)
        self._active: List[OrderedDict] = [OrderedDict()
                                           for _ in range(num_devices)]
        self._cache_locks = [threading.Lock() for _ in range(num_devices)]
        self._next_pid = 0
        self.stats = {"dispatches": 0, "swaps_in": 0, "swaps_out": 0,
                      "xdev_transfers": 0}
        self._stats_lock = threading.Lock()
        # persistent per-device worker loops + shared lightweight pool
        self.executor = Executor(num_devices, device_prep=self._device_prep,
                                 pool_size=pool_size, max_pending=max_pending)

    # ------------------------------------------------------------------
    def register(self, particle, device: Optional[int] = None) -> int:
        pid = self._next_pid
        self._next_pid += 1
        dev = device if device is not None else pid % len(self.devices)
        self._device_of[pid] = dev
        self._particles[pid] = particle
        self.executor.add_particle(pid, dev)
        return pid

    def unregister(self, pid: int):
        """Retire a particle: drop it from the device table and registry,
        evict it from its device's LRU active set, and remove its
        executor mailbox. Raises KeyError for unknown/dead pids, so a late
        ``dispatch`` to one fails loudly."""
        dev = self._device_of.pop(pid)      # KeyError for unknown pid
        self._particles.pop(pid, None)
        with self._cache_locks[dev]:
            self._active[dev].pop(pid, None)
        self.executor.remove_particle(pid)

    def rebalance(self) -> Dict[int, tuple]:
        """Re-place live particles evenly across devices (round-robin in
        pid order). Drains in-flight messages first so no mailbox is
        moved while scheduled; returns {pid: (old_dev, new_dev)} for the
        particles that moved."""
        self.drain()
        moves: Dict[int, tuple] = {}
        for i, pid in enumerate(sorted(self._particles)):
            dev = i % len(self.devices)
            old = self._device_of[pid]
            if old == dev:
                continue
            with self._cache_locks[old]:
                self._active[old].pop(pid, None)
            self._device_of[pid] = dev
            self.executor.move_particle(pid, dev)
            moves[pid] = (old, dev)
        return moves

    def device_of(self, pid: int) -> torch.device:
        return self.devices[self._device_of[pid]]

    def particle_ids(self) -> List[int]:
        return sorted(self._particles)

    def particle(self, pid: int):
        return self._particles[pid]

    def _bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self.stats[key] += n

    # ------------------------------------------------------------------
    # active-set / particle-cache management (paper's context switching)
    # ------------------------------------------------------------------
    def _device_prep(self, dev_idx: int, pid: int):
        # pool items (dev_idx == -1) never prep a device
        if dev_idx >= 0:
            dev = self.devices[dev_idx]
            if dev.type == "cuda":
                torch.cuda.set_device(dev)      # per thread
            self.ensure_resident(pid)

    def ensure_resident(self, pid: int):
        """LRU bookkeeping of the device's active set. The particle's rows
        stay in the store on its one device (no offload in the port)."""
        dev_idx = self._device_of[pid]
        with self._cache_locks[dev_idx]:
            active = self._active[dev_idx]
            if pid in active:
                active.move_to_end(pid)
                return
            if len(active) >= self.cache_size:
                active.popitem(last=False)      # LRU evict
                self._bump("swaps_out")
            active[pid] = True
            self._bump("swaps_in")

    # ------------------------------------------------------------------
    # dispatch: one hop of particle `pid`'s timeline
    # ------------------------------------------------------------------
    def dispatch(self, pid: int, fn: Callable, *args,
                 needs_device: bool = False, lightweight: bool = False,
                 **kwargs) -> PFuture:
        if pid not in self._particles:
            # a dead pid must fail loudly, not silently queue (the
            # lightweight pool would otherwise accept it forever)
            raise KeyError(f"particle {pid} is not registered")
        self._bump("dispatches")
        return self.executor.submit(pid, fn, args, kwargs,
                                    needs_device=needs_device,
                                    lightweight=lightweight)

    def drain(self, timeout: Optional[float] = None):
        """Block until every dispatched message has run to completion."""
        self.executor.drain(timeout)

    def shutdown(self):
        self.executor.shutdown(drain=True)
