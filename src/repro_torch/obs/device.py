"""obs.device — device gauges and per-Program cost attribution
(counterpart of ``repro.obs.device``).

Gauges answer the memory-budgeting questions: what each device holds
(``device_gauges``: the caching allocator's bytes and the device's total;
None on the CPU, as the reference's are), how full the store is
(``store_gauges``: capacity, the live mask, per-device bytes, dtypes and
the precision policy per key) and how full a decode page pool is
(``pool_gauges``).

Cost attribution. The reference asks XLA for a program's cost on demand
(a second, AOT compile). A CUDA graph cannot be analysed once captured,
and a step cannot be run again to count it: the train, collect and
serve-cast steps update their state in place. So the port counts a
program on its first run, the warm-up that ``runtime.program.capture``
makes anyway or an eager program's first call, under ``counting()``: a
``TorchDispatchMode`` that adds each aten op's FLOPs (by
``torch.utils.flop_counter``'s formulas: products and convolutions) and
the bytes of its operands and results, which is what XLA's ``bytes
accessed`` sums per HLO op (views and allocations count nothing; a copy
or fill does not read what it overwrites; an in-place write at indices,
``index_copy_`` / ``index_put_`` / ``scatter_``, moves its update and its
indices, as the reference's ``hlo_cost`` counts a scatter). A
hand-written kernel is no aten op: its wrapper ``charge``s its own FLOPs
and bytes from its shapes (``cost(...)`` beside each wrapper in
``kernels/``, the formula of its bound in ``chip_smoke.py``), and only
while a count is open. The mode passes every op through unchanged, so a
counted run computes the same bits. ``program_cost(program)`` assembles
the reference's dict from the count; ``Program.cost()`` memoizes it.

The dry run (``launch.cost``) opens a count with ``dry_run``, which keeps
three more ledgers: ``devices`` attributes each op's FLOPs and bytes to
the device of its output, by device index (a kernel's charge to the
device its wrapper names); ``charge_collective`` adds the bytes a
cross-position transfer
brings to the receiving position, by the reference's collective kinds
(``COLLECTIVES``), where the port makes them (``models.tp.reduce_sum``
and ``all_gather``, SVGD's gather over ``data``), and any other copy
between two devices (autograd's backward of those transfers, a
replicated leaf's copy) as a "collective-permute", its site the nearest
caller in the package; ``live`` / ``peak`` keep the
live bytes of the storages the count saw made, per device, and their
peak. ``trips(n)`` marks a loop of equal trips (the microbatches): a dry
run's count runs the first trip alone and multiplies what that trip
counted by ``n``, as the reference's ``hlo_cost`` multiplies a while body
by its trip count. Only a count on fake tensors may be a dry run's: the
skipped trips do not run.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_MEM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
             "largest_alloc_size")


def _largest_alloc(i: int) -> int:
    """The largest block the caching allocator has handed out on device
    ``i`` that is still allocated."""
    return max((b["size"] for seg in torch.cuda.memory_snapshot()
                if seg["device"] == i for b in seg["blocks"]
                if b["state"] == "active_allocated"), default=0)


def device_gauges(devices=None) -> List[Dict[str, Any]]:
    """One entry per CUDA device (platform ``"gpu"``, kind its name, the
    caching allocator's bytes in use and peak, the device's total and the
    largest live block); one ``"cpu"`` entry with None memory fields where
    there is no CUDA device. ``devices`` (the ``torch.device``s a PD's mesh
    and NEL use, repeats allowed) narrows the entries to the CUDA devices
    among them, one each, and keeps the ``"cpu"`` entry when a CPU device
    is among them."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        cuda = sorted({d.index or 0 for d in devices if d.type == "cuda"})
        out = [{"id": 0, "platform": "cpu", "kind": "cpu",
                **dict.fromkeys(_MEM_KEYS)}] if any(
            d.type == "cpu" for d in devices) else []
        return out + [g for g in device_gauges() if g["platform"] == "gpu"
                      and g["id"] in cuda]
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 **dict.fromkeys(_MEM_KEYS)}]
    out = []
    for i in range(torch.cuda.device_count()):
        out.append({"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1],
                    "largest_alloc_size": _largest_alloc(i)})
    return out


def store_gauges(store) -> Dict[str, Any]:
    """Store occupancy: capacity, live count, the live-slot mask (host
    side), per-device and per-particle bytes for every key (from the leaf
    dtypes: a bf16 store reports half the fp32 bytes), the dtypes and the
    precision policy."""
    lc = store.lifecycle_stats()
    live = set(store.live_slots())
    keys = store.keys()
    return {
        "capacity": lc["capacity"],
        "live": lc["live"],
        "free_slots": lc["free_slots"],
        "generation": lc["generation"],
        "live_mask": [1 if s in live else 0 for s in range(lc["capacity"])],
        "per_device_bytes": {k: store.per_device_bytes(k) for k in keys},
        "per_particle_bytes": {k: store.per_particle_bytes(k) for k in keys},
        "dtypes": {k: store.key_dtypes(k) for k in keys},
        "precision": store.precision.describe(),
    }


def pool_gauges(pool) -> Dict[str, Any]:
    """Page-pool occupancy (paged KV decode)."""
    return pool.snapshot_stats()


# ---------------------------------------------------------------------------
# counting a program's first run
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# allocations: no byte of data moves
_FREE = frozenset((_aten.empty, _aten.empty_strided, _aten.empty_like,
                   _aten.new_empty, _aten.new_empty_strided))
# ops that overwrite their first operand without reading it
_WRITE_ONLY = frozenset((_aten.copy_, _aten.fill_, _aten.zero_))
# questions about a tensor's metadata: no data moves (a fake tensor
# answers ``.device`` through the dispatcher, a real one does not)
_QUERIES = frozenset((torch.ops.prim.device.default,
                      torch.ops.prim.layout.default,
                      _aten.sym_size.int, _aten.sym_stride.int,
                      _aten.sym_numel.default,
                      _aten.sym_storage_offset.default,
                      _aten.is_contiguous.default))
# in-place writes at indices: (op, (the index operand's, the update's
# positions)); they move the update and the indices, not the buffer
_INDEXED = {_aten.index_copy_: (2, 3), _aten.index_put_: (1, 2),
            _aten.scatter_: (2, 3)}
# copies that may cross devices: (op, source operand's index)
_COPIES = {_aten._to_copy: 0, _aten.copy_: 1}

_local = threading.local()


def leaf_bytes(x) -> int:
    """Bytes of one tree leaf: a tensor's or a numpy array's data, 0 for
    anything else."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (np.ndarray, np.generic)):
        return int(x.nbytes)
    return 0


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts), in order: a faster walk than a general pytree's."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _indexed_bytes(packet, args) -> int:
    """An in-place write at indices: the update read and written once,
    the indices read (the reference's count of a scatter or a dynamic
    update slice: what moves, not the buffer it lands in)."""
    at_index, at_update = _INDEXED[packet]
    index = sum(t.numel() * t.element_size()
                for t in _tensors(args[at_index], []))
    update = args[at_update] if len(args) > at_update else None
    if isinstance(update, torch.Tensor):
        moved_ = update.numel() * update.element_size()
    else:                           # a scalar value: one element an index
        moved_ = (_tensors(args[at_index], [])[0].numel()
                  * args[0].element_size())
    return 2 * moved_ + index


def _index(x) -> Optional[int]:
    """The device index of the first tensor in ``x`` (None for none, or
    for a device without an index)."""
    ts = _tensors(x, [])
    return ts[0].device.index if ts else None


class _Count(TorchDispatchMode):
    """Adds up the FLOPs and bytes of the aten ops run under it, and what
    kernel wrappers ``charge``; with ``dry_run`` the dry run's ledgers as
    well (module docstring)."""

    def __init__(self, dry_run: bool = False, by_op: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        # {aten op, or "charge" for a kernel's: [flops, bytes]} when by_op
        self.by_op: Optional[Dict[str, List[int]]] = {} if by_op else None
        self.loop_aware = dry_run      # ``trips`` runs one trip
        self.mult = 1                  # the trips of the loop being counted
        # {device index: [flops, bytes]} in a dry run
        self.devices: Optional[Dict[Any, List[int]]] = (
            {} if dry_run else None)
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.device_coll: Dict[Any, Dict[str, int]] = {}
        # (kind, site, bytes each, device index) -> calls (a call inside
        # a loop-aware loop counts as its trips)
        self.sites: Dict[tuple, int] = {}
        self.memory = dry_run
        self._explicit = False         # inside ``moved``: charged there
        self.live: Dict[Any, int] = {}
        self.peak: Dict[Any, int] = {}
        self._seen: Dict[int, Any] = {}
        self._known: set = set()

    def collective(self, kind: str, nbytes: int, site: str, index) -> None:
        self.coll[kind] += nbytes
        per = self.device_coll.setdefault(index,
                                          dict.fromkeys(COLLECTIVES, 0))
        per[kind] += nbytes
        key = (kind, site, nbytes, index)
        self.sites[key] = self.sites.get(key, 0) + self.mult

    def _add(self, flops: int, nbytes: int, index, op="charge") -> None:
        self.flops += flops
        self.bytes += nbytes
        if self.by_op is not None:
            acc = self.by_op.setdefault(str(op), [0, 0])
            acc[0] += flops
            acc[1] += nbytes
        if self.devices is not None:
            acc = self.devices.setdefault(index, [0, 0])
            acc[0] += flops
            acc[1] += nbytes

    def know(self, tensors) -> None:
        """Storages that existed before the count (a step's arguments):
        they are not the step's temporaries."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._known.add(id(t.untyped_storage()))

    def _track(self, out) -> None:
        for t in _tensors(out, []):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen or key in self._known:
                continue
            n, index = st.nbytes(), t.device.index
            self._seen[key] = True
            live = self.live[index] = self.live.get(index, 0) + n
            self.peak[index] = max(self.peak.get(index, 0), live)
            weakref.finalize(st, self._free, key, n, index)

    def _free(self, key, n, index) -> None:
        self._seen.pop(key, None)
        self.live[index] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _QUERIES or func.is_view:
            return out
        packet = func._overloadpacket
        if self.memory:
            self._track(out)
        if packet in _FREE:
            return out
        formula = flop_registry.get(packet)
        flops = (int(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0)
        if packet in _INDEXED:
            nbytes = _indexed_bytes(packet, args)
        else:
            read = args[1:] if packet in _WRITE_ONLY else args
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors((read, kwargs, out), []))
        index = None
        if self.devices is not None:
            index = _index(out)
            if index is None:
                index = _index((args, kwargs))
            if packet in _COPIES and not self._explicit:
                self._transfer(args[_COPIES[packet]], out)
        self._add(flops, nbytes, index, packet)
        return out

    def _transfer(self, src, dst) -> None:
        """A copy between two devices (neither the host) that ``moved``
        did not charge: a "collective-permute" at ``dst``'s device."""
        if not isinstance(src, torch.Tensor) or src.device == dst.device \
                or "cpu" in (src.device.type, dst.device.type):
            return
        self.collective("collective-permute",
                        dst.numel() * dst.element_size(), _site(2),
                        dst.device.index)

    def snapshot(self):
        """The ledgers' values now (``trips`` scales what follows)."""
        return (self.flops, self.bytes,
                None if self.devices is None else
                {k: list(v) for k, v in self.devices.items()},
                None if self.by_op is None else
                {k: list(v) for k, v in self.by_op.items()},
                dict(self.coll),
                {k: dict(v) for k, v in self.device_coll.items()})

    def scale_since(self, snap, n: int) -> None:
        """Add ``n - 1`` times what was counted since ``snap``."""
        flops, nbytes, devices, by_op, coll, dcoll = snap
        k = n - 1
        self.flops += k * (self.flops - flops)
        self.bytes += k * (self.bytes - nbytes)
        for now, then in ((self.devices, devices), (self.by_op, by_op)):
            for i, acc in (now or {}).items():
                f0, b0 = then.get(i, (0, 0))
                acc[0] += k * (acc[0] - f0)
                acc[1] += k * (acc[1] - b0)
        for kind in self.coll:
            self.coll[kind] += k * (self.coll[kind] - coll[kind])
        for i, per in self.device_coll.items():
            for kind, v in per.items():
                per[kind] += k * (v - dcoll.get(i, {}).get(kind, 0))


@contextlib.contextmanager
def counting(*, dry_run: bool = False, by_op: bool = False):
    """Count what runs on this thread inside the block; yields the count
    (``flops``, ``bytes``; with ``dry_run`` also ``devices``,
    ``device_coll``, ``sites``, ``live`` / ``peak`` and a loop-aware
    ``trips``; with ``by_op`` ``by_op``, the two by aten op, the kernels'
    charges under "charge"; module docstring)."""
    count = _Count(dry_run, by_op)
    outer = getattr(_local, "count", None)
    _local.count = count
    try:
        with count:
            yield count
    finally:
        _local.count = outer


def counting_now() -> bool:
    """True inside ``counting()`` on this thread: a kernel wrapper works
    out its cost only then."""
    return getattr(_local, "count", None) is not None


def charge(flops: int, nbytes: int, device=None) -> None:
    """Add a hand-written kernel's FLOPs and bytes to the open count, on
    ``device`` (the device its wrapper launches on)."""
    count = getattr(_local, "count", None)
    if count is not None:
        count._add(int(flops), int(nbytes),
                   None if device is None else torch.device(device).index)


def charge_collective(kind: str, nbytes: int, site: str,
                      device=None) -> None:
    """Add ``nbytes`` that a cross-position transfer of ``kind`` (one of
    ``COLLECTIVES``) brings to ``device``, made at ``site``, to the open
    count."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; one of "
                         f"{COLLECTIVES}")
    count = getattr(_local, "count", None)
    if count is None:
        return
    count.collective(kind, int(nbytes), site,
                     None if device is None else torch.device(device).index)


def _site(depth: int) -> str:
    """``module.function`` of the nearest frame of this package above
    ``depth`` frames up the stack (outside ``obs``)."""
    f = sys._getframe(depth)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and "/obs/" not in name:
            return f"{name.rsplit('/', 1)[-1][:-3]}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


def moved(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """``t.to(device)``; inside a count, a transfer between two devices
    is charged to ``device`` as a collective of ``kind``, its site the
    module and function that called the collective (the caller's
    caller: ``tp._mlp`` for a ``tp.reduce_sum`` there)."""
    device = torch.device(device)
    count = getattr(_local, "count", None)
    if t.device == device or count is None:
        return t.to(device)
    f = sys._getframe(2).f_code
    site = f"{f.co_filename.rsplit('/', 1)[-1][:-3]}.{f.co_name}"
    charge_collective(kind, t.numel() * t.element_size(), site, device)
    count._explicit = True
    try:
        return t.to(device)
    finally:
        count._explicit = False


def trips(n: int):
    """``range(n)`` for a loop of ``n`` equal trips; under a loop-aware
    count, the first trip alone, and what it counted times ``n``."""
    count = getattr(_local, "count", None)
    if count is None or not count.loop_aware or n <= 1:
        yield from range(n)
        return
    snap, outer = count.snapshot(), count.mult
    count.mult = outer * n
    try:
        yield 0
    finally:
        count.mult = outer
    count.scale_since(snap, n)


def program_cost(program) -> Optional[Dict[str, Any]]:
    """The reference's cost dict for one Program, from what its first run
    counted: ``flops``, ``bytes_accessed``, ``param_bytes_per_device``,
    ``memory`` (argument and output bytes; ``temp_bytes`` the captured
    graph's private pool, 0 for an eager program) and ``loop_aware`` (the
    same counts: a graph replays every launch its capture recorded, so no
    loop is counted once for many trips). None before the first run.
    Prefer the memoizing ``Program.cost()``."""
    counted = program.counted
    if counted is None:
        return None
    return {"flops": float(counted["flops"]),
            "bytes_accessed": float(counted["bytes"]),
            "param_bytes_per_device": program.param_bytes_per_device,
            "memory": {"argument_bytes": counted["argument_bytes"],
                       "output_bytes": counted["output_bytes"],
                       "temp_bytes": program.pool_bytes},
            "loop_aware": {"flops": float(counted["flops"]),
                           "bytes": float(counted["bytes"]),
                           "collectives": {}}}
