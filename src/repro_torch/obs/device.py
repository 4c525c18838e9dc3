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
or fill does not read what it overwrites). A hand-written kernel is no
aten op: its wrapper ``charge``s its own FLOPs and bytes from its shapes
(``cost(...)`` beside each wrapper in ``kernels/``, the formula of its
bound in ``chip_smoke.py``), and only while a count is open. The mode
passes every op through unchanged, so a counted run computes the same
bits. ``program_cost(program)`` assembles the reference's dict from the
count; ``Program.cost()`` memoizes it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
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

_local = threading.local()


def leaf_bytes(x) -> int:
    """Bytes of one tree leaf: a tensor's or a numpy array's data, 0 for
    anything else."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (np.ndarray, np.generic)):
        return int(x.nbytes)
    return 0


class _Count(TorchDispatchMode):
    """Adds up the FLOPs and bytes of the aten ops run under it, and what
    kernel wrappers ``charge``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.is_view or packet in _FREE:
            return out
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        read = args[1:] if packet in _WRITE_ONLY else args
        self.bytes += sum(leaf_bytes(x) for x in tree_leaves(
            (read, kwargs, out)))
        return out


@contextlib.contextmanager
def counting():
    """Count what runs on this thread inside the block; yields the count
    (``flops``, ``bytes``)."""
    count = _Count()
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


def charge(flops: int, nbytes: int) -> None:
    """Add a hand-written kernel's FLOPs and bytes to the open count."""
    count = getattr(_local, "count", None)
    if count is not None:
        count.flops += int(flops)
        count.bytes += int(nbytes)


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
