"""ProgramSpec -> Program: step capture (counterpart of
``repro.runtime.program``).

A ``ProgramSpec`` describes one fixed-shape step: its body, built by
``make(ctx)``, and the role of every positional argument, which decides
how the argument crosses into a captured step. The reference jits a spec
and its ProgramCache keeps the executable; here a spec is captured once as
a CUDA graph and replayed.

Argument kinds (``in_kinds``):

  "state"       stacked per-particle state with a leading particle axis
                (params; the page pool). Read and updated IN PLACE at
                fixed addresses: the graph holds the addresses, so the
                leaves' ``data_ptr()`` and strides join the cache key
                (``arg_key``). A store commit that replaces a tree gives
                new addresses, so the key misses and the step is captured
                anew: a graph is never replayed on memory it does not own.
                The particle count is read off the first "state" argument.
  "rows"        a tree whose every leaf has a leading particle axis but is
                not parameter state (dense KV caches); in place, as "state".
  "replicated"  step inputs shared by every particle (the scheduler's
                packed int32 staging buffer, a batch): copied into the
                program's static inputs before each replay. Numpy arrays,
                tensors and Python ints or floats are taken.
  "vector"      per-particle scalars (P,) (the active mask): copied, as
                "replicated".

Host-side ints that shape the body (the draft's slot and iteration
count) belong in ``spec.key``, one spec per value. Output kinds
(``out_kinds``) allow ``"in:<i>"``: that output is argument ``i`` updated
in place, and a replay hands back the caller's own tree.

``lower(spec, args)`` routes by the device of the arguments, as
``kernels.ops`` does: on a CUDA device ``capture`` warms the body up once
on a side stream (kernel builds, library handles, plans), then captures it
into a ``torch.cuda.CUDAGraph``; a failure to capture raises, with no
eager run in its place. On the CPU ``eager`` runs the body as it is.

A body that must check a copied input on the host (the dense decode
step's position against its cache) calls ``host_check`` on the value it
received: in a capture the check runs on the caller's value before the
warm-up launches anything with it, and again before every replay, so a
captured step raises where the eager body raises.

The kernels' launch counters (``launches`` on each wrapper of
``kernels.ops.COUNTED``) are bumped on the host, so a replay alone would
not count: a captured ``Program`` records each counter's change during
capture, takes it back (nothing ran), and adds it again at every replay.

A program's cost (``Program.cost()``, the reference's keys) is counted on
its first run, under ``obs.device.counting``: the capture's warm-up, or an
eager program's first call (a step that updates its state in place cannot
be run again to be counted). Before that run ``cost()`` is None.
With tracing on, each call records a ``program.<name>`` span (cat
``runtime``) and opens ``torch.profiler.record_function(
"repro.program.<name>")``, so a profile taken alongside carries a marker
per program; with tracing off a call pays one flag check. The reference's
``aot_dump`` and ``preload`` have no counterpart: a CUDA graph cannot be
serialized, and ``kernels/build.py`` already caches the compiled kernels
between processes.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.store import Sharded
from ..core.tree import Group, tree_flatten, tree_leaves, tree_map
from ..kernels.ops import COUNTED
from ..obs import clock
from ..obs import device as _obs
from ..obs import trace as _trace

IN_KINDS = ("state", "replicated", "vector", "rows")
IN_PLACE = ("state", "rows")


# ---------------------------------------------------------------------------
# stable identity tokens and argument keys
# ---------------------------------------------------------------------------

_token_lock = threading.Lock()
_tokens: "weakref.WeakKeyDictionary[Any, int]" = weakref.WeakKeyDictionary()
_token_counter = itertools.count()


def ident(obj) -> Any:
    """Stable hashable identity token for an object referenced by a spec
    key. ``id()`` alone can be reused after GC; a weakref-keyed token
    cannot collide while either object is alive."""
    try:
        with _token_lock:
            tok = _tokens.get(obj)
            if tok is None:
                tok = next(_token_counter)
                _tokens[obj] = tok
            return tok
    except TypeError:  # not weakref-able / unhashable: fall back to id
        return ("id", id(obj))


def _structure(tree):
    if tree is None:
        return None
    if isinstance(tree, Group):
        return ("group", tuple(_structure(s) for s in tree.shards))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "*"


def _leaf_key(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    if isinstance(x, (np.ndarray, np.generic)):
        return tuple(x.shape), x.dtype.name
    if isinstance(x, (bool, int, float)):
        return (), type(x).__name__
    raise TypeError(f"a program argument leaf must be a tensor, a numpy "
                    f"array or a Python scalar, got {type(x).__name__}")


def abstract_key(tree) -> Tuple:
    """Hashable (structure, shapes, dtypes) key for one argument."""
    return (_structure(tree),
            tuple(_leaf_key(x) for x in tree_leaves(tree)))


def arg_key(kind: str, arg) -> Tuple:
    """The cache-key entry of one argument: its abstract key, plus the
    addresses and strides of its leaves when ``kind`` is read in place;
    for a ``Sharded`` argument, the plan and one such entry per shard."""
    if isinstance(arg, Sharded):
        return ("sharded", arg.plan,
                tuple(arg_key(kind, s) for s in arg.shards))
    key = abstract_key(arg)
    if kind in IN_PLACE:
        key += (tuple((x.data_ptr(), x.stride())
                      for x in tree_leaves(arg)),)
    return key


def _host_value(x):
    """What ``host_check`` reads of a copied argument's leaf as the caller
    passed it: a Python scalar, a numpy array or a CPU tensor as it is;
    None for a device tensor, which is never read on the host."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return None
    return x


_checking = threading.local()


def host_check(value, check: Callable) -> None:
    """Check on the host the value a copied step input was filled from.

    ``value`` is the leaf of a "replicated" or "vector" argument as the
    body received it, ``check(host value)`` raises on a bad one. In a
    capture's warm-up the check runs at once on the caller's value, and
    the program runs it again on each call's value before the replay.
    Anywhere else it does nothing: an eager body receives the caller's
    value itself and checks it there, and a caller that passes a device
    tensor keeps the check. A device tensor's value is never read."""
    ctx = getattr(_checking, "ctx", None)
    if ctx is None:
        return
    where = ctx["where"].get(id(value))
    if where is None:
        raise RuntimeError("host_check of a value that is not a leaf of a "
                           "copied argument")
    i, j, host = where
    if host is not None:
        check(host)
    ctx["found"].append((i, j, check))


def arg_device(args) -> Optional[torch.device]:
    """The device of the first tensor among ``args`` (None if none); the
    walk stops there, so a step's lookup never flattens the params."""
    if isinstance(args, torch.Tensor):
        return args.device
    if isinstance(args, Group):
        return args.devices[0]
    if isinstance(args, dict):
        args = list(args.values())
    for a in args if isinstance(args, (tuple, list)) else ():
        device = arg_device(a)
        if device is not None:
            return device
    return None


# ---------------------------------------------------------------------------
# spec / build context / program
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BuildCtx:
    """What ``ProgramSpec.make`` builds against: the particle count of the
    first "state" argument and the device of the arguments."""
    num_particles: int
    device: Optional[torch.device]


@dataclass(frozen=True)
class ProgramSpec:
    """Declarative description of one fixed-shape step (module doc)."""
    name: str                       # human-readable (stats)
    key: Tuple                      # stable semantic identity (hashable)
    make: Callable                  # make(ctx: BuildCtx) -> fn(*args)
    in_kinds: Tuple[str, ...]       # one kind per positional argument
    out_kinds: Optional[Tuple[str, ...]] = None
    precision: Optional[Tuple] = None   # core.precision key; None = fp32
    # (members, combine) for a body that reduces over the particle axis:
    # on sharded arguments the members spec runs at every position on
    # all arguments but the last (the mask) and returns (member outputs,
    # *in-place outputs); the combine spec reduces the gathered member
    # outputs with the mask on the first position (ShardedProgram)
    split: Optional[Tuple["ProgramSpec", "ProgramSpec"]] = None

    def __post_init__(self):
        for k in self.in_kinds:
            if k not in IN_KINDS:
                raise ValueError(f"unknown in_kind {k!r}")
        for k in (self.out_kinds or ()):
            if k not in ("replicated", "vector", "rows") \
                    and not k.startswith("in:"):
                raise ValueError(f"unknown out_kind {k!r}")


class Program:
    """A step ready to run: a captured CUDA graph with its static inputs
    and outputs, or (``graph`` None) the body run eagerly.

    ``__call__`` runs the body's host checks (``host_check``) on the
    call's values, copies the "replicated" and "vector" arguments into
    the static inputs, replays the graph and returns copies of the static
    outputs, so a caller may keep them across calls, with every
    ``"in:<i>"`` output replaced by the caller's argument ``i``.
    ``pool_bytes`` is the device memory the capture reserved for the
    graph's private pool. A pinned host tensor is copied asynchronously:
    its caller may refill it only once the stream has passed the call.
    ``counted`` holds what the first run counted (module doc), and
    ``param_bytes_per_device`` the bytes of the first "state" argument."""

    __slots__ = ("name", "cache_key", "num_particles", "fn", "graph",
                 "in_kinds", "static_args", "static_out", "out_args",
                 "launches", "capture_s", "first", "checks", "pool_bytes",
                 "param_bytes_per_device", "counted", "_cost")

    def __init__(self, name, cache_key, num_particles, fn=None, graph=None,
                 in_kinds=(), static_args=(), static_out=None, out_args=(),
                 launches=(), capture_s: float = 0.0, first=None, checks=(),
                 pool_bytes: int = 0, param_bytes_per_device: int = 0,
                 counted=None):
        self.name = name
        self.cache_key = cache_key
        self.num_particles = num_particles
        self.fn = fn
        self.graph = graph
        self.in_kinds = in_kinds
        self.static_args = static_args
        self.static_out = static_out
        self.out_args = out_args            # ((output index, arg index),)
        self.launches = launches            # ((kernel wrapper, count),)
        self.capture_s = capture_s
        self.first = first                  # (warm-up args, its outputs)
        self.checks = checks                # ((arg index, leaf, check),)
        self.pool_bytes = pool_bytes
        self.param_bytes_per_device = param_bytes_per_device
        self.counted = counted
        self._cost = None

    def __call__(self, *args):
        tr = _trace.TRACER
        if not tr.enabled:
            return self._run(args)
        t0 = clock.now()
        with torch.profiler.record_function(f"repro.program.{self.name}"):
            out = self._run(args)
        tr.record(f"program.{self.name}", "runtime", t0, clock.now(),
                  {"n": self.num_particles})
        return out

    def cost(self):
        """The memoized cost dict (``obs.device.program_cost``: flops,
        bytes_accessed, param_bytes_per_device, memory, loop_aware); None
        until the program's first run has been counted."""
        if self._cost is None:
            self._cost = _obs.program_cost(self)
        return self._cost

    def cost_if_computed(self):
        return self._cost

    def _run(self, args):
        if self.graph is None:
            if self.counted is not None:
                return self.fn(*args)
            with _obs.counting() as count:
                out = self.fn(*args)
            self.counted = _counted(count, args, out)
            return out
        first, self.first = self.first, None
        if first is not None and all(a is b for a, b in zip(args, first[0])):
            return first[1]         # the warm-up ran this very call
        for i, j, check in self.checks:
            host = _host_value(tree_leaves(args[i])[j])
            if host is not None:
                check(host)
        for kind, static, a in zip(self.in_kinds, self.static_args, args):
            if kind not in IN_PLACE:
                _copy_into(static, a)
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        out = tree_map(torch.Tensor.clone, self.static_out)
        if not self.out_args:
            return out
        out = list(out)
        for o, i in self.out_args:
            out[o] = args[i]
        return tuple(out)

    def __repr__(self) -> str:
        mode = "graph" if self.graph is not None else "eager"
        return f"Program({self.name!r}, n={self.num_particles}, {mode})"


_h2d = threading.local()


def h2d_copies() -> int:
    """The host-to-device copies that programs have issued on the calling
    thread: one per host leaf (a numpy array, or a tensor on the CPU) of a
    copied argument, counted where the leaf is copied into a static input
    (``_copy_into``, ``_static_copy``) or moved to the device eagerly
    (``_as_tensors``). A caller reads it before and after its calls."""
    return getattr(_h2d, "n", 0)


def _on_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic)) or (
        isinstance(x, torch.Tensor) and x.device.type == "cpu")


def _count_h2d(leaf, device) -> None:
    if _on_host(leaf) and torch.device(device).type != "cpu":
        _h2d.n = h2d_copies() + 1


def _copy_into(static, arg):
    leaves, _ = tree_flatten(static)
    for s, a in zip(leaves, tree_leaves(arg)):
        if isinstance(a, (torch.Tensor, np.ndarray, np.generic)):
            _count_h2d(a, s.device)
            s.copy_(torch.as_tensor(a), non_blocking=True)
        else:
            s.fill_(a)


def _static_copy(arg, device):
    """A device-resident copy of a copied argument: the static input."""
    leaves, unflatten = tree_flatten(arg)
    for a in leaves:
        _count_h2d(a, device)
    return unflatten([torch.as_tensor(a).to(device, copy=True)
                      for a in leaves])


def _as_tensors(arg, device):
    """Host leaves of a copied argument (numpy arrays, CPU tensors) as
    tensors on ``device`` (the eager path); device tensors and Python
    scalars pass through."""
    leaves, unflatten = tree_flatten(arg)
    for a in leaves:
        _count_h2d(a, device)
    return unflatten([torch.as_tensor(a).to(device) if _on_host(a) else a
                      for a in leaves])


def _num_particles(spec: ProgramSpec, args) -> int:
    for kind, a in zip(spec.in_kinds, args):
        if kind == "state":
            return tree_leaves(a)[0].shape[0]
    return 0


def _tree_bytes(tree) -> int:
    return sum(_obs.leaf_bytes(x) for x in tree_leaves(tree))


def _param_bytes_per_device(spec: ProgramSpec, args) -> int:
    """Bytes of the first "state" argument on one device: all of it, or
    a model group's largest shard."""
    for kind, a in zip(spec.in_kinds, args):
        if kind == "state":
            if isinstance(a, Group):
                return max(_tree_bytes(s) for s in a.shards)
            return _tree_bytes(a)
    return 0


def _counted(count, args, out):
    """What a counted first run gives ``obs.device.program_cost``."""
    return {"flops": count.flops, "bytes": count.bytes,
            "argument_bytes": _tree_bytes(args),
            "output_bytes": _tree_bytes(out)}


def _build(spec: ProgramSpec, args):
    if len(args) != len(spec.in_kinds):
        raise ValueError(f"{spec.name}: {len(args)} arguments for "
                         f"{len(spec.in_kinds)} kinds")
    device = arg_device(args)
    n = _num_particles(spec, args)
    return spec.make(BuildCtx(num_particles=n, device=device)), device, n


def eager(spec: ProgramSpec, args, cache_key=None) -> Program:
    """The body run as it is, under ``torch.no_grad``: the CPU's program,
    and the explicit eager pass a comparison asks for on the card
    (``ProgramCache(capturer=eager)``)."""
    fn, device, n = _build(spec, args)
    kinds = spec.in_kinds

    def run(*call_args):
        with torch.no_grad():
            return fn(*(a if k in IN_PLACE else _as_tensors(a, device)
                        for k, a in zip(kinds, call_args)))

    return Program(spec.name, cache_key, n, fn=run, in_kinds=kinds,
                   param_bytes_per_device=_param_bytes_per_device(spec, args))


def _in_place_outputs(spec: ProgramSpec, out, args):
    """((output index, argument index),) of the ``"in:<i>"`` outputs,
    each checked to be its argument's own tensors (updated in place)."""
    pairs = tuple((o, int(k[3:])) for o, k in enumerate(spec.out_kinds or ())
                  if k.startswith("in:"))
    for o, i in pairs:
        got = [x.data_ptr() for x in tree_leaves(out[o])]
        want = [x.data_ptr() for x in tree_leaves(args[i])]
        if got != want:
            raise RuntimeError(f"{spec.name}: output {o} must be argument "
                               f"{i} updated in place")
    return pairs


_warm_up_streams: dict = {}


def _warm_up_stream(device) -> "torch.cuda.Stream":
    """One side stream per device for every warm-up, so that what a
    library keeps for each stream it has run on (cuBLAS's workspace) is
    made once, not once per capture."""
    stream = _warm_up_streams.get(device)
    if stream is None:
        stream = _warm_up_streams[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def _host_checks(kinds, static, args):
    """While the body is built, ``host_check`` maps each static leaf of a
    copied argument to the caller's value; yields the checks it found as
    ``(argument index, leaf index, check)``."""
    where = {}
    for i, (kind, s, a) in enumerate(zip(kinds, static, args)):
        if kind not in IN_PLACE:
            for j, (sl, al) in enumerate(zip(tree_leaves(s),
                                             tree_leaves(a))):
                where[id(sl)] = (i, j, _host_value(al))
    found = []
    _checking.ctx = {"where": where, "found": found}
    try:
        yield found
    finally:
        _checking.ctx = None


def capture(spec: ProgramSpec, args, cache_key=None) -> Program:
    """Warm the body up once on a side stream, then capture it as a CUDA
    graph over static copies of the copied arguments and the in-place
    arguments themselves. Raises if the capture fails, and raises what a
    ``host_check`` raises on these arguments before the warm-up launches
    anything with the value it checks.

    The warm-up runs the step for real on these arguments: it is the
    first call's execution, and the run the program's cost is counted
    on. The program's first call with these very argument objects returns
    the warm-up's outputs without a replay, so every call runs the step,
    and launches each kernel, exactly once."""
    fn, device, n = _build(spec, args)
    if device is None or device.type != "cuda":
        raise ValueError(f"{spec.name}: capture needs CUDA arguments, got "
                         f"{device}")
    kinds = spec.in_kinds
    static = tuple(a if k in IN_PLACE else _static_copy(a, device)
                   for k, a in zip(kinds, args))
    with torch.no_grad(), torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = _warm_up_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), _host_checks(kinds, static,
                                                   args) as checks, \
                _obs.counting() as count:
            warm = fn(*static)
        counted = _counted(count, static, warm)
        current.wait_stream(side)
        torch.cuda.synchronize(device)
        before = [k.launches for k in COUNTED]
        # what torch.cuda.graph does on entry, done first, so that the
        # reserved bytes grow by the graph's private pool alone. A full
        # collection (the LM's particles sit in reference cycles) only
        # when less than half the device is free: it costs 0.1-0.2 s at a
        # large heap, and torch's own entry stopped collecting for that
        free, total = torch.cuda.mem_get_info(device)
        if free < total // 2:
            gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*static)
        finally:
            recorded = [k.launches - b for k, b in zip(COUNTED, before)]
            for k, b in zip(COUNTED, before):
                k.launches = b              # captured, not launched
        took = time.perf_counter() - t0
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
    pairs = _in_place_outputs(spec, out, static)
    if pairs:
        out = list(out)
        for o, _ in pairs:
            out[o] = None                   # the caller's tree, at replay
        out = tuple(out)
    # past its first call the program keeps no reference to an in-place
    # argument: a tree that a commit replaced is freed, and its addresses
    # key no more lookups
    static = tuple(None if k in IN_PLACE else a for k, a in zip(kinds, static))
    return Program(spec.name, cache_key, n, graph=graph, in_kinds=kinds,
                   static_args=static, static_out=out, out_args=pairs,
                   launches=tuple((k, r) for k, r in zip(COUNTED, recorded)
                                  if r),
                   capture_s=took, first=(tuple(args), warm),
                   checks=tuple(checks), pool_bytes=pool_bytes,
                   param_bytes_per_device=_param_bytes_per_device(spec, args),
                   counted=counted)


def spans_devices(args) -> bool:
    """Whether a model group among ``args`` sits on more than one device
    (distinct GPUs)."""
    return any(isinstance(a, Group) and len(set(a.devices)) > 1
               for a in args)


def lower(spec: ProgramSpec, args, cache_key=None) -> Program:
    """The default capturer: a CUDA graph for CUDA arguments, the eager
    body for CPU ones; any other device raises. A step over a model group
    that spans several GPUs runs eagerly (``ShardedProgram``)."""
    device = arg_device(args)
    if device is not None and device.type == "cuda" \
            and not spans_devices(args):
        return capture(spec, args, cache_key)
    if device is not None and device.type == "cuda":
        return eager(spec, args, cache_key)
    if device is None or device.type == "cpu":
        return eager(spec, args, cache_key)
    raise ValueError(f"{spec.name}: no program for device {device}")


# ---------------------------------------------------------------------------
# programs over a mesh: one per position
# ---------------------------------------------------------------------------

def device_guard(device):
    """The current-device context a position's launches and captures run
    in (CUDA; nothing for the CPU)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedProgram:
    """A spec over ``Sharded`` arguments (``core.store``): one ``Program``
    per data position, each run on that position's shard of every
    sharded argument, under the position's device.

    Under a model axis a data position's shard is a ``core.tree.Group``
    and its program runs the model group's ``m`` shards layer by layer
    (``models.tp``): the row-parallel reductions sit inside every layer,
    twice, so they are inside the program, each a sum of the ``m``
    partials in position order handed to every position. When every
    position of the group is one device (one card, the CPU tests) the
    program captures as one CUDA graph. On distinct GPUs it runs eagerly
    (``lower``): one graph would have to hold launches on several
    devices and the copies between them, and a graph per device between
    reductions would be ``2 * n_layers + 1`` programs a step with a
    host-side hand-off at every one; neither is measured on a machine
    with one card.

    Arguments: a ``Sharded`` one gives each position its shard; a
    "vector" tensor of the stack's length gives each position its slice
    (memoized on the tensor object, so the store's mask is sliced once per
    lifecycle event); any other argument (a batch, the scheduler's staging
    buffer) reaches every position whole, a device tensor copied once per
    call to each other device. Outputs: ``"in:<i>"`` is argument i itself;
    "vector" outputs are gathered in slot order onto the first position.

    A spec with a ``split`` reduces over the particle axis: its members
    spec runs at every position, the member outputs are copied in slot
    order into a buffer on the first position, and the combine spec (one
    more program there, captured on that buffer) reduces them with the
    mask, the last argument; the result does not depend on the number of
    positions. No collective over the particle axis is inside a captured
    graph: a gather is a copy between two programs.

    The programs come from the cache that built this one, keyed on the
    placement's plan and the position. The first call with the very
    arguments of the lookup reuses the per-position arguments each
    program was captured with, so each warm-up is that call's run."""

    def __init__(self, cache, spec: ProgramSpec, args, state_token,
                 arg_keys):
        sharded = next(a for a in args if isinstance(a, Sharded))
        self.cache = cache
        self.spec = spec
        self.name = spec.name
        self.devices = sharded.devices
        self.bounds = sharded.bounds
        self.plan = sharded.plan
        self.token = state_token
        self.members, self.combine_spec = (spec.split if spec.split
                                           else (spec, None))
        self.combine: Optional[Program] = None
        self._buf = None
        self._vector = None                 # (tensor, its slices)
        m_args = args[:-1] if spec.split else args
        per = self._position_args(m_args)
        self.programs = []
        for i, (device, a) in enumerate(zip(self.devices, per)):
            keys = None if arg_keys is None else [
                k[2][i] if isinstance(k, tuple) and k and k[0] == "sharded"
                else None for k in arg_keys[:len(m_args)]]
            with device_guard(device):
                prog, _ = cache.lookup(self.members, a,
                                       (state_token, self.plan, i), keys)
            self.programs.append(prog)
        self._first = (tuple(args), per)

    @property
    def num_particles(self) -> int:
        return self.bounds[-1]

    def _vector_parts(self, v):
        memo = self._vector
        if memo is not None and memo[0] is v:
            return memo[1]
        v = torch.as_tensor(v)
        parts = [v[lo:hi].to(d) for d, lo, hi in
                 zip(self.devices, self.bounds[:-1], self.bounds[1:])]
        self._vector = (v, parts)
        return parts

    def _position_args(self, args):
        kinds = self.members.in_kinds
        per = [[] for _ in self.devices]
        moved = {}
        for kind, a in zip(kinds, args):
            if isinstance(a, Sharded):
                if a.bounds != self.bounds:
                    raise ValueError(f"{self.name}: sharded arguments on "
                                     "different layouts")
                parts = a.shards
            elif kind in IN_PLACE:
                raise ValueError(f"{self.name}: an in-place argument of a "
                                 "program on a mesh must be sharded")
            elif kind == "vector":
                parts = self._vector_parts(a)
            else:
                parts = []
                for d in self.devices:
                    if d not in moved:
                        moved[d] = tree_map(
                            lambda x, d=d: x.to(d)
                            if isinstance(x, torch.Tensor)
                            and not _on_host(x) else x, a)
                    parts.append(moved[d])
            for p, part in zip(per, parts):
                p.append(part)
        return [tuple(p) for p in per]

    def __call__(self, *args):
        first, self._first = self._first, None
        m_args = args[:-1] if self.spec.split else args
        if first is not None and all(a is b for a, b in zip(args, first[0])):
            per = first[1]
        else:
            per = self._position_args(m_args)
        outs = []
        for device, prog, a in zip(self.devices, self.programs, per):
            with device_guard(device):
                outs.append(prog(*a))
        if self.spec.split:
            return self._combined(outs, args)
        return self._assembled(self.spec.out_kinds, outs, args, 0)

    def _assembled(self, kinds, outs, args, start):
        """The outputs of kinds[start:] from each position's outputs."""
        if kinds is None:
            raise ValueError(f"{self.name}: a program on a mesh needs out "
                             "kinds (or a split)")
        res = []
        for o, kind in enumerate(kinds[start:], start):
            if kind.startswith("in:"):
                res.append(args[int(kind[3:])])
            elif kind in ("vector", "rows"):
                first = self.devices[0]
                res.append(tree_map(
                    lambda *xs: torch.cat([x.to(first) for x in xs]),
                    *[out[o] for out in outs]))
            else:
                raise ValueError(f"{self.name}: a {kind!r} output of a "
                                 "program on a mesh needs a split")
        return res

    def _combined(self, outs, args):
        first = self.devices[0]
        members = [out[0] for out in outs]
        if self._buf is None:
            self._buf = tree_map(
                lambda *xs: torch.empty((self.bounds[-1],) + tuple(
                    xs[0].shape[1:]), dtype=xs[0].dtype, device=first),
                *members)
        buf = self._buf
        for lo, hi, m in zip(self.bounds[:-1], self.bounds[1:], members):
            tree_map(lambda b, x, lo=lo, hi=hi: b[lo:hi].copy_(x), buf, m)
        mask = args[-1]
        with device_guard(first):
            if self.combine is None:
                self.combine, _ = self.cache.lookup(
                    self.combine_spec, (buf, mask),
                    (self.token, self.plan, "combine"))
            head = self.combine(buf, mask)
        if self.spec.out_kinds is None:
            return head
        return (head,) + tuple(self._assembled(self.spec.out_kinds, outs,
                                               args, 1))

    def __repr__(self) -> str:
        return (f"ShardedProgram({self.name!r}, n={self.bounds[-1]}, "
                f"positions={len(self.devices)})")
