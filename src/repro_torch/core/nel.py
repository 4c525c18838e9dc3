"""Node Event Loop (paper §4.2) — the particle runtime (counterpart of
``repro.core.nel``).

A NEL owns (1) a particle-to-device lookup table, (2) a per-device
*active set* (the particle cache): at most ``cache_size`` particles are
resident per device, the least recently used swapped out first, and (3)
a persistent ``Executor`` — one long-lived worker loop per device plus a
shared lightweight pool (executor.py). ``dispatch`` *enqueues* one hop of
a particle's logical timeline onto its device's loop; no thread is ever
created per message.

  * "device" = a ``torch.device``. ``num_devices=N`` on CUDA gives one
    worker for each of ``cuda:0 .. cuda:N-1``; ``devices=`` takes an
    explicit list, which may name one device several times (logical
    workers sharing it: the CPU tests' and a one-card machine's
    counterpart of the reference's forced host devices). With a CPU
    store, ``num_devices`` logical workers share the CPU. Each worker
    makes its device current before a hop (``device_prep``), since the
    current CUDA device is per thread.
  * *device* work (forward / backward / parameter updates) runs on the
    target device's single worker loop, which serializes compute per
    device while letting different devices progress concurrently (the
    paper's Fig. 3b). Every hop runs on the device's default stream.
  * messages to one particle execute in FIFO send order (per-particle
    mailboxes); distinct particles on a device round-robin.
  * lightweight state reads (``get``/views) run on the shared pool and
    never queue behind device compute.
  * ``send`` returns immediately with a PFuture (async-await).

Residency, as the reference's: on a swap-in a particle's ``"params"``
row moves to its device when ``offload`` is set or the NEL has more than
one worker; under ``offload`` the least recently used particle's
``"params"`` row leaves the device for host memory (pinned on CUDA,
allocated once per particle and reused) when the active set is full.
Only ``"params"`` moves. Under either, the PD's store keeps rows where
the NEL put them (``ParticleStore.keep_row_devices``) and a stacked
``"params"`` is demoted to rows at the first swap, so that an offloaded
row frees its device memory; a fused consumer restacks it.
``swap_stats`` counts the bytes and seconds of those copies.

Handlers may freely send-and-wait on other particles: a blocked handler
context-switches its worker into servicing the device queue (the
paper's call-stack context switch — see Executor._make_wait_hook), so a
waiting handler never starves the particle it is waiting on.

Instrumentation (``stats`` + ``executor.stats()``) counts dispatches,
swaps, cross-device transfers, queue depths and wait-vs-run time.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .executor import Executor
from .messages import PFuture
from .tree import tree_leaves, tree_map, tree_to


def _has_state(p) -> bool:
    """A particle with store-backed params (a bare registered object, as
    scheduling tests use, has no rows to move)."""
    return hasattr(p, "state") and "params" in p.state


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class NodeEventLoop:
    def __init__(self, num_devices: Optional[int] = None, cache_size: int = 4,
                 offload: bool = False, max_pending: int = 4096,
                 pool_size: Optional[int] = None, device=None,
                 devices: Optional[Sequence] = None):
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
            if not self.devices:
                raise ValueError("devices= names no device")
            num_devices = len(self.devices)
        else:
            device = torch.device("cuda" if device is None else device)
            if num_devices is None:
                num_devices = 1
            if device.type == "cuda":
                present = torch.cuda.device_count()
                if num_devices > present:
                    raise ValueError(
                        f"requested {num_devices} devices but only {present} "
                        "present; pass devices= with a device repeated to "
                        "emulate")
                if num_devices == 1:
                    index = device.index if device.index is not None else 0
                    self.devices = [torch.device("cuda", index)]
                else:
                    self.devices = [torch.device("cuda", i)
                                    for i in range(num_devices)]
            else:
                self.devices = [device] * num_devices   # logical workers
        self.cache_size = cache_size
        self.offload = offload
        # offloaded rows: pid -> host tree reused at every eviction
        self._host: Dict[int, Any] = {}
        self._out: set = set()              # pids whose row is on the host
        self.swap_stats = {"bytes_in": 0, "bytes_out": 0, "s_in": 0.0,
                           "s_out": 0.0}
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

    @property
    def homes_rows(self) -> bool:
        """Whether swaps move particles' params rows (offload, or more
        than one worker)."""
        return self.offload or len(self.devices) > 1

    def unregister(self, pid: int):
        """Retire a particle: drop it from the device table and registry,
        evict it from its device's LRU active set, and remove its
        executor mailbox. Raises KeyError for unknown/dead pids, so a late
        ``dispatch`` to one fails loudly."""
        dev = self._device_of.pop(pid)      # KeyError for unknown pid
        self._particles.pop(pid, None)
        with self._cache_locks[dev]:
            self._active[dev].pop(pid, None)
        self._host.pop(pid, None)
        self._out.discard(pid)
        self.executor.remove_particle(pid)

    def rebalance(self) -> Dict[int, tuple]:
        """Re-place live particles evenly across devices (round-robin in
        pid order). Drains in-flight messages first so no mailbox is
        moved while scheduled; a moved particle's mailbox and, when the
        NEL homes rows, its device-resident params row move together.
        Returns {pid: (old_dev, new_dev)} for the particles that moved."""
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
            p = self._particles[pid]
            if self.homes_rows and _has_state(p) and pid not in self._out:
                p.state["params"] = tree_to(p.state["params"],
                                           self.devices[dev])
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
        """The device's active set (LRU): a particle not in it is swapped
        in, evicting the least recently used when full (module doc)."""
        dev_idx = self._device_of[pid]
        dev = self.devices[dev_idx]
        with self._cache_locks[dev_idx]:
            active = self._active[dev_idx]
            if pid in active:
                active.move_to_end(pid)
                return
            if len(active) >= self.cache_size:
                victim, _ = active.popitem(last=False)      # LRU evict
                self._bump("swaps_out")
                vp = self._particles[victim]
                if self.offload and _has_state(vp):
                    self._swap_out(vp)
            p = self._particles[pid]
            if self.homes_rows and _has_state(p):
                self._swap_in(p, dev)
            active[pid] = True
            self._bump("swaps_in")

    def _swap_out(self, p):
        """The victim's params row into its host buffer (pinned on CUDA),
        which becomes the row."""
        p.store.demote("params")
        row = p.state["params"]
        host = self._host.get(p.pid)
        if host is None:
            host = self._host[p.pid] = tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype, device="cpu",
                                      pin_memory=x.is_cuda), row)
        t0 = time.perf_counter()
        tree_map(lambda h, x: h.copy_(x), host, row)
        self.swap_stats["s_out"] += time.perf_counter() - t0
        self.swap_stats["bytes_out"] += _nbytes(row)
        p.state["params"] = host
        self._out.add(p.pid)

    def _swap_in(self, p, dev):
        """The particle's params row onto its device: a copy from its host
        buffer when offloaded, else a move (no copy where it already is)."""
        p.store.demote("params")
        row = p.state["params"]
        if p.pid in self._out:
            t0 = time.perf_counter()
            row = tree_map(lambda x: x.to(dev, copy=True), row)
            self.swap_stats["s_in"] += time.perf_counter() - t0
            self.swap_stats["bytes_in"] += _nbytes(row)
            self._out.discard(p.pid)
        else:
            row = tree_to(row, dev)
        p.state["params"] = row

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
