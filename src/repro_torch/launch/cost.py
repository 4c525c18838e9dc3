"""What one device does in a step: the dry run's count (counterpart of
``repro.launch.hlo_cost``).

The reference compiles each step for the production mesh and reads the
per-device program's HLO text, multiplying a while body by its trip
count. The port has no HLO: ``cost`` runs the step on its fake inputs
(``launch.steps.build``) under ``obs.device.counting`` and reads what one
device did, model position 0 of data position 0:

  * ``flops``   the products' FLOPs (``torch.utils.flop_counter``'s
                formulas) and the hand-written kernels' own ``cost(...)``
                (their fake forms charge it);
  * ``bytes``   each aten op's operand and result bytes and the kernels'
                charges (views and allocations count nothing);
  * ``coll``    {kind: bytes} of the reference's collective kinds, each
                transfer charged where it lands (``obs.device``).

Loop awareness: the microbatch loop (``obs.device.trips``) runs one trip,
and what that trip counted is multiplied by the trip count, as
``hlo_cost`` multiplies a while body; the accumulation inside the loop
counts with it, the rest of the step once. Within a trace the layers run
in Python, each counted as it runs.

The unit stack is a loop too: the reference scans its units and
``hlo_cost`` multiplies the body. The port's units run in Python, and a
full-size trace of every unit on fake tensors takes minutes a row (each
fake op costs the host ~0.3 ms, and a training step at 16 model
positions runs ~10^5 of them a unit). ``extrapolate`` counts a stack of
n identical units from two traces, at 1 and at 2 units: the step's work
is the part outside the units plus n times one unit's, so count(n) =
count(1) + (n - 1) (count(2) - count(1)), exact for FLOPs, bytes,
collectives and the argument and output bytes (a test holds it to a
trace of every unit); the peak of temporaries is taken on the same line.

Memory (``memory``): ``argument_size_in_bytes`` and
``output_size_in_bytes`` are exact, the bytes of the device's leaves of
the step's arguments and outputs; ``temp_size_in_bytes`` is the peak of
the live bytes of the storages the step made on the device (outputs made
during the step included: the reference's donated outputs alias its
arguments). It leaves out the caching allocator's rounding and
fragmentation, a captured graph's private pool and the kernels' scratch.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
from torch._guards import detect_fake_mode

from ..core.tree import tree_leaves
from ..obs import device as obs
from ..obs.device import COLLECTIVES


def _leaves(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _bytes_on(tensors, index) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t.device.index != index:
            continue
        key = (id(t.untyped_storage()), t.storage_offset(), t.numel())
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def cost(step, *args, trips: bool = True, device: int = 0) -> Dict:
    """The count of one ``step(*args)`` on fake inputs for the device of
    index ``device``: ``{"flops", "bytes", "coll": {kind: bytes},
    "memory": {...}, "sites": [...], "trace_s", "totals"}`` (module
    docstring; ``totals`` sums every device, by aten op too, and
    ``sites`` feeds ``top_collectives``). ``trips=False`` runs every
    trip of the microbatch loop."""
    mode = detect_fake_mode(args)
    if mode is None:
        raise ValueError("cost traces fake inputs: build the step with "
                         "launch.steps.build(...) and no init")
    t0 = time.perf_counter()
    with mode, obs.counting(dry_run=True, by_op=True) as count:
        count.loop_aware = trips
        count.know(_leaves(args))
        out = step(*args)
    trace_s = time.perf_counter() - t0
    flops, nbytes = count.devices.get(device, (0, 0))
    coll = {k: v for k, v in count.device_coll.get(device, {}).items()
            if v > 0}
    return {
        "flops": float(flops), "bytes": float(nbytes), "coll": coll,
        "memory": {
            "argument_size_in_bytes": _bytes_on(_leaves(args), device),
            "output_size_in_bytes": _bytes_on(_leaves(out), device),
            "temp_size_in_bytes": count.peak.get(device, 0)},
        "sites": [(kind, site, each, calls) for (kind, site, each, index),
                  calls in count.sites.items() if index == device],
        "trace_s": trace_s,
        "totals": {"flops": float(count.flops), "bytes": float(count.bytes),
                   "coll": {k: v for k, v in count.coll.items() if v},
                   "by_op": count.by_op},
    }


def extrapolate(one: Dict, two: Dict, n: int) -> Dict:
    """The count of a stack of ``n`` identical units from ``cost``'s
    counts of the same step at 1 and at 2 units (module docstring)."""
    def line(a, b):
        return a + (n - 1) * (b - a)

    kinds = set(one["coll"]) | set(two["coll"])
    a, b = _by_site(one), _by_site(two)
    sites = []
    for key in sorted(set(a) | set(b)):
        (b1, c1), (b2, c2) = a.get(key, (0, 0)), b.get(key, (0, 0))
        calls = line(c1, c2)
        if calls > 0:
            sites.append((*key[:1], key[1], line(b1, b2) / calls, calls))
    return {
        "flops": line(one["flops"], two["flops"]),
        "bytes": line(one["bytes"], two["bytes"]),
        "coll": {k: line(one["coll"].get(k, 0), two["coll"].get(k, 0))
                 for k in sorted(kinds)},
        "memory": {k: int(line(one["memory"][k], two["memory"][k]))
                   for k in one["memory"]},
        "sites": sites,
        "trace_s": one["trace_s"] + two["trace_s"],
        "totals": {"flops": line(one["totals"]["flops"],
                                 two["totals"]["flops"]),
                   "bytes": line(one["totals"]["bytes"],
                                 two["totals"]["bytes"])},
        "units": n,
    }


def _by_site(counted: Dict) -> Dict:
    """{(kind, site): [bytes, calls]} of a count's collective calls."""
    out: Dict = {}
    for kind, site, each, calls in counted["sites"]:
        acc = out.setdefault((kind, site), [0, 0])
        acc[0] += each * calls
        acc[1] += calls
    return out


def top_collectives(counted: Dict, k: int = 12
                    ) -> List[Tuple[str, float, int, float, str]]:
    """The largest collective sites of a ``cost`` result: (kind, bytes x
    calls, calls, bytes a call, site), the largest first, as the
    reference's ``hlo_cost.top_collectives`` lists (kind, bytes x trips,
    trips, bytes, op name). A site is the function that made the
    transfer; its calls may move different sizes (bytes a call is their
    mean), and a call inside the microbatch loop counts its trips."""
    rows = [(kind, float(total), int(calls), float(total / calls), site)
            for (kind, site), (total, calls) in _by_site(counted).items()]
    rows.sort(key=lambda r: (-r[1], r[4]))
    return rows[:k]


def count(cfg, shape, plan, mesh, bdl: str = "ensemble", *,
          every_unit: bool = False):
    """(the count, the placement) of ``launch.steps.build``'s step for one
    (config, shape, plan, mesh): ``extrapolate``d from 1 and 2 units when
    the stack has more, unless ``every_unit``."""
    from .steps import build

    def one(c):
        step, args, placement = build(c, shape, plan, mesh, bdl=bdl)
        return cost(step, *args), placement

    if every_unit or cfg.n_units <= 2:
        return one(cfg)
    c1, placement = one(cfg.replace(n_units=1))
    c2, _ = one(cfg.replace(n_units=2))
    return extrapolate(c1, c2, cfg.n_units), placement


__all__ = ["COLLECTIVES", "cost", "count", "extrapolate",
           "top_collectives"]
