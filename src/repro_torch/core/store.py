"""ParticleStore: the single source of truth for per-particle state.

Counterpart of ``repro.core.store``. ``Placement`` is the reference's
plan record: ``mesh=None`` keeps every particle on the store's device; a
``launch.mesh.Mesh`` puts the particle axis on a ``data`` axis of
positions and, with a ``model`` axis larger than 1, each particle across
a model group of positions (2D placement): position ``(i, j)`` holds
data slice ``i`` of the slot rows and model shard ``j`` of every leaf the
sharding rules split (``sharding.rules``); a leaf with no rule, or one
whose dim the axis does not divide, is replicated, whole at every
position of the group, and every write keeps its ``m`` copies bit-equal.
One data position's stack is then a ``core.tree.Group`` of its model
shards. ``StoreState`` is one particle's mapping view of the store
(``particle.state``).

  * canonical form — one *stacked* tree per state key ("params",
    "kv_pages", ...) with a leading particle axis, on ``device``; under a
    mesh whose ``data`` axis divides the capacity, one such stack per
    position (``Sharded``): ``capacity / data`` contiguous slots on that
    position's device, the layout the reference's GSPMD split of the
    padded axis gives. A capacity the axis does not divide is not split
    (the reference's ``_axis_fits``): it stays one stack on the first
    position (its first model group, under a model axis);
  * derived form — per-particle *views* (``leaf[slot]``, no copy) with
    dirty-tracked write-back.

Elastic lifecycle (DESIGN.md §9): the store allocates by **capacity, not
count**. Stacked trees are padded to a power-of-two ``capacity``; each
live particle owns a *slot*, freed slots go on a free list, and
``active_mask()`` (shape ``(capacity,)``, 1.0 at live slots) tells fused
steps which rows are real. ``generation()`` bumps only on capacity growth,
a key seen for the first time or a ``reshard``, never on churn within
capacity: ``clone_slot`` copies one slot's rows into another inside the
stacked tensors (``copy_``, jitter added in place), and ``unregister``
flips the mask, so both keep every stacked tensor at its address and a step
captured on those addresses (``runtime.program``) stays valid. Capacity
growth (``_grow``, ``torch.cat``) and ``reshard`` (the store moved onto
another placement) are the events that move them.

Consistency protocol (all transitions under one lock):

  write(pid)       -> row cached + marked dirty; shadows the stacked row
  stacked()        -> flush: dirty rows copied into the stacked tensors in
                      place, or a full restack padded to capacity (free
                      slots zero) when no canonical stacked exists
  checkout()       -> flush + move ownership to the caller, who updates
                      the tensors (in place, for the paged KV pool) and
                      must ``commit`` them back
  commit(stacked)  -> the caller's tree becomes canonical

With a pid list, ``stacked`` / ``dense`` / ``checkout`` return a fresh
dense stack of those rows (index i <-> pids[i]) and ``commit`` writes
row i back as pids[i]'s dirty row, flushed in place into the canonical
tensors. The canonical form is never dropped for a subset (the
reference demotes it to rows, ``_demote_to_rows``): a restack would give
the full-live-set steps new addresses, and so new captures.

Unlike the reference's immutable arrays, a flush writes into the stacked
tensors in place: a consumer holding the stacked tree sees the new rows.
Serving steps and store churn are serialized by the scheduler's
``step_lock``.

Rows may live elsewhere than their stack: with ``keep_row_devices`` set
(the PD sets it when its NEL offloads or spans several devices) a
written row stays where its leaves are (a NEL device, or pinned host
memory under offload) and moves to its stack only at the next flush;
``demote`` drops a key's stacked form for independent rows, so that an
offloaded row frees its device memory. Capacity growth under a mesh
re-lays the slots out: the stacks become rows (views of the old shards)
that the next flush restacks.

``stats`` keeps the reference's counters: ``unstacks`` counts rows sliced
out of a stacked tree (a read of a stacked row, a subset commit's rows),
``device_puts`` placements onto a mesh (a restack split over the
positions, a plain tree committed to a mesh store; 0 on one device, as
the reference's with ``mesh=None``). Spans (DESIGN.md §12, cat ``store``):
``store.checkout``, ``store.commit``, ``store.h2d`` around a write whose
leaves come from the host, and the ``store.generation_bump`` instant at
capacity growth and at a reshard.
"""
from __future__ import annotations

import bisect
import heapq
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..obs import trace as _trace
from ..sharding import rules as _rules
from .precision import get as _resolve_precision
from .tree import Group, tree_flatten, tree_leaves, tree_map


@dataclass(frozen=True, eq=False)
class Placement:
    """The reference's placement plan (``repro.core.store.Placement``):
    a mesh (``launch.mesh.Mesh``) and which of its axes carries which
    role. ``particle_axis`` splits the stacked particle axis into
    contiguous slot ranges, one per position; ``mesh=None`` keeps every
    particle on the store's device. A ``model_axis`` larger than 1 splits
    one particle across its devices in mode "tp" (``models.tp``: each data
    position's stack a ``core.tree.Group`` of model shards); another mode
    raises ``ValueError``.

    Equality and hashing are by plan: two placements over separately
    built meshes with the same axes, sizes and devices (a device's key is
    ``(type, index, position)``, so logical positions on one card stay
    distinct) compare equal, and the program cache keys on
    ``plan_key()``."""
    mesh: Any = None
    particle_axis: Optional[str] = "data"
    mode: str = "tp"
    model_axis: Optional[str] = "model"

    def __post_init__(self):
        if self.model_axis_size() > 1 and self.mode != "tp":
            raise ValueError(f"a model axis places in mode 'tp', not "
                             f"{self.mode!r}")

    # -- plan identity -------------------------------------------------------
    def plan_key(self) -> tuple:
        if self.mesh is None:
            mesh_key = None
        else:
            mesh_key = (tuple(self.mesh.axis_names),
                        tuple(int(self.mesh.shape[a])
                              for a in self.mesh.axis_names),
                        tuple((d.type, d.index, pos) for pos, d in
                              enumerate(self.mesh.flat_devices())))
        return (mesh_key, self.particle_axis, self.model_axis, self.mode)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Placement):
            return NotImplemented
        return self.plan_key() == other.plan_key()

    def __hash__(self) -> int:
        return hash(self.plan_key())

    @staticmethod
    def auto(particle_axis: str = "data", mode: str = "tp", model: Any = 1,
             *, params_bytes: Optional[int] = None, param_tree: Any = None,
             precision: Any = None,
             device_memory_bytes: Optional[int] = None,
             devices: Optional[Sequence] = None) -> "Placement":
        """A mesh over every visible CUDA device (or ``devices``).
        ``model`` sets the model-axis size; ``model="auto"`` picks the
        smallest whose parameter shard fits the device's memory
        (``launch.mesh.pick_model_axis``), from ``params_bytes`` or from
        ``param_tree`` counted at the ``precision``'s master itemsize
        (``core.precision.tree_bytes``; an explicit ``params_bytes`` with a
        ``precision`` is rescaled from fp32). With n <= 1 devices and
        model <= 1: ``Placement(mesh=None)``."""
        from ..launch.mesh import make_bench_mesh, pick_model_axis
        from .precision import tree_bytes
        n = (len(devices) if devices is not None
             else torch.cuda.device_count())
        if model == "auto":
            if params_bytes is None and param_tree is not None:
                params_bytes = tree_bytes(param_tree, precision)
            elif params_bytes is not None and precision is not None:
                itemsize = torch.finfo(
                    _resolve_precision(precision).master).bits // 8
                params_bytes = int(params_bytes * itemsize / 4)
            model = pick_model_axis(params_bytes or 0, n,
                                    device_memory_bytes=device_memory_bytes)
        model = int(model)
        if n <= 1 and model <= 1:
            return Placement(mesh=None)
        return Placement(mesh=make_bench_mesh(n, model=model,
                                              devices=devices),
                         particle_axis=particle_axis, mode=mode)

    # -- axis sizes ----------------------------------------------------------
    def _axis_size(self, axis: Optional[str]) -> int:
        if self.mesh is None or axis is None:
            return 1
        return int(dict(self.mesh.shape).get(axis, 1))

    def particle_axis_size(self) -> int:
        return self._axis_size(self.particle_axis)

    def model_axis_size(self) -> int:
        return self._axis_size(self.model_axis)

    def _axis_fits(self, n: int, axis: Optional[str]) -> Optional[str]:
        if self.mesh is None or axis is None:
            return None
        size = dict(self.mesh.shape).get(axis)
        return axis if size and n > 0 and n % size == 0 else None

    def spmd_axis(self, n: int) -> Optional[str]:
        """The particle axis when it divides ``n`` rows, else None."""
        return self._axis_fits(n, self.particle_axis)

    # -- layouts -------------------------------------------------------------
    def groups(self) -> List[Tuple[torch.device, ...]]:
        """The devices of each data position's model group, data position
        by data position: ``(i, 0) .. (i, m-1)``; one device each without
        a model axis (every position of the mesh is then a data
        position)."""
        if self.mesh is None:
            return []
        if self.model_axis_size() <= 1:
            return [(d,) for d in self.mesh.flat_devices()]
        names = list(self.mesh.axis_names)
        grid = np.moveaxis(self.mesh.devices, names.index(self.model_axis),
                           -1)
        return [tuple(g) for g in grid.reshape(-1, grid.shape[-1])]

    def positions(self) -> List[torch.device]:
        """The device of each data position, in order: its model group's
        first device."""
        return [g[0] for g in self.groups()]

    def devices(self) -> List[torch.device]:
        """Every position's device, data position by data position."""
        return [d for g in self.groups() for d in g]

    def vector(self, n: int) -> Optional[Tuple[Tuple[int, Any, slice], ...]]:
        """Where the rows of an (n, ...) stack live: ``(data position,
        device, slice of rows)`` per data position, contiguous in slot
        order, when the particle axis divides n; None (no split) otherwise
        or with no mesh. Under a model axis a stack is always split over
        the model group: rows the particle axis does not divide stay on
        the first data position."""
        if self.mesh is None or n <= 0:
            return None
        if self.spmd_axis(n) is None:
            if self.model_axis_size() <= 1:
                return None
            return ((0, self.positions()[0], slice(0, n)),)
        pos = self.positions()
        k = n // len(pos)
        return tuple((i, d, slice(i * k, (i + 1) * k))
                     for i, d in enumerate(pos))

    def shardings(self, stacked_tree):
        """``vector`` of the tree's leading dimension."""
        return self.vector(_leading(stacked_tree) or 0)

    def matrix(self, n: int, d: int):
        """The flattened (n, D) particle matrix (SVGD): rows over the data
        positions (``vector``); under a model axis each position of a
        group holds its model shard's block of the D columns
        (``bdl.svgd._MeshStep``)."""
        return self.vector(n)

    def gathered_matrix(self, d: int):
        """The (n, D) matrix after the gather over ``data`` only: every
        row at the first data position's group, D still split over the
        model axis: ``(model position j, device of (0, j), every row)``
        per j (one entry without a model axis)."""
        if self.mesh is None:
            return None
        return tuple((j, dev, slice(None))
                     for j, dev in enumerate(self.groups()[0]))

    def activation_policy(self) -> Optional[Dict[str, Any]]:
        """The ``sharding.policy`` map of this plan (None without a model
        axis to split over)."""
        if self.mesh is None or self.model_axis_size() <= 1:
            return None
        from ..sharding.policy import tp_activation_policy
        return tp_activation_policy(dict(self.mesh.shape), self.model_axis)

    # -- the model axis ----------------------------------------------------
    def model_dims(self, tree, lead: int = 1) -> Dict[str, Optional[int]]:
        """Each leaf's model dim under this plan (``sharding.rules.
        model_dims``; ``lead`` leading stacking axes)."""
        return _rules.model_dims(tree, self.model_axis_size(), lead=lead,
                                 mode=self.mode,
                                 model_axis=self.model_axis or "model")

    def to_group(self, tree, i: int, *, lead: int = 1, dims=None) -> Group:
        """``tree`` (a plain tree, or a Group of any layout) as a Group on
        data position ``i``'s model group: each position's shard copied
        to its device (a replicated leaf copied whole to every
        position, so the copies are bit-equal)."""
        devs = self.groups()[i]
        m = len(devs)
        if isinstance(tree, Group):
            if len(tree) == m and tree.dims is not None:
                return Group([tree_map(lambda x, d=d: x.to(d), s)
                              for s, d in zip(tree.shards, devs)],
                             tree.dims, devs)
            tree = join_group(tree)
        if dims is None:
            dims = self.model_dims(tree, lead)
        leaves, unflatten = tree_flatten(tree)
        paths = [p for p, _ in _rules.named_leaves(tree)]
        return Group([unflatten([
            _rules.split_leaf(x, dims[p], m, j).to(d, copy=True).contiguous()
            for p, x in zip(paths, leaves)]) for j, d in enumerate(devs)],
            dims, devs)

    def split(self, tree, n: Optional[int] = None) -> "Sharded":
        """A plain stacked tree copied onto this plan's layout of its
        ``n`` rows (the tree's leading dim by default): each data
        position's rows on its device or, under a model axis, as a Group
        over its model group."""
        n = _leading(tree) if n is None else n
        layout = self.vector(n)
        if self.model_axis_size() <= 1:
            shards = [tree_map(lambda x, s=s, d=d: x[s].to(d, copy=True),
                               tree) for _, d, s in layout]
        else:
            dims = self.model_dims(tree, 1)
            shards = [self.to_group(tree_map(lambda x, s=s: x[s], tree), i,
                                    dims=dims) for i, _, s in layout]
        return Sharded(shards, [d for _, d, _ in layout], self.plan_key())


def join_group(group, device=None):
    """The whole tree of a Group (``core.tree.Group``) on ``device`` (its
    first position's by default): each split leaf's shards concatenated
    in position order, each replicated leaf taken from the first
    position. A plain tree is moved as it is."""
    if not isinstance(group, Group):
        return tree_map(lambda x: x.to(device), group) if device is not None \
            else group
    if group.dims is None:
        raise ValueError("a Group made by model code has no dims to join by")
    per = [tree_leaves(s) for s in group.shards]
    _, unflatten = tree_flatten(group.shards[0])
    paths = [p for p, _ in _rules.named_leaves(group.shards[0])]
    return unflatten([_rules.join_leaf([leaves[k] for leaves in per],
                                       group.dims[path], device)
                      for k, path in enumerate(paths)])


def _whole(tree, device):
    """A row or stack on ``device``: joined when it is a Group."""
    if isinstance(tree, Group):
        return join_group(tree, device)
    return _to(tree, device)


def _bytes_per_device(tree) -> int:
    """The bytes one device holds of a stack (a Group's largest shard)."""
    if isinstance(tree, Group):
        return max(_tree_bytes(s) for s in tree.shards)
    return _tree_bytes(tree)


class Sharded:
    """A stacked tree split over the positions of a mesh: ``shards[i]``
    holds rows ``[bounds[i], bounds[i+1])`` on ``devices[i]``, in slot
    order; under a model axis ``shards[i]`` is a ``Group`` over data
    position i's model group and ``devices[i]`` its first device.
    ``plan`` is the placement's ``plan_key()``. Consumers run a program
    per data position (``runtime.program.ShardedProgram``)."""

    __slots__ = ("shards", "devices", "bounds", "plan", "__weakref__")

    def __init__(self, shards, devices, plan=None):
        self.shards = tuple(shards)
        self.devices = tuple(torch.device(d) for d in devices)
        self.plan = plan
        bounds = [0]
        for s in self.shards:
            bounds.append(bounds[-1] + (_leading(s) or 0))
        self.bounds = tuple(bounds)

    def __len__(self) -> int:
        return self.bounds[-1]

    def __repr__(self) -> str:
        return f"Sharded(rows={self.bounds}, devices={list(self.devices)})"

    def locate(self, slot: int) -> Tuple[int, int]:
        """(position, row within its shard) of a slot."""
        i = bisect.bisect_right(self.bounds, slot) - 1
        return i, slot - self.bounds[i]

    def row(self, slot: int):
        """One slot's row: a view into its shard."""
        i, j = self.locate(slot)
        return tree_map(lambda x: x[j], self.shards[i])

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every shard, same layout."""
        return Sharded([fn(s) for s in self.shards], self.devices, self.plan)

    def leaves(self) -> list:
        return [x for s in self.shards for x in tree_leaves(s)]

    def gather(self, device=None):
        """The whole stack as one tree on ``device`` (the first
        position's by default): one copy of every shard, model shards
        joined."""
        device = self.devices[0] if device is None else torch.device(device)
        return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                        *[_whole(s, device) for s in self.shards])

    @staticmethod
    def apply(fn, tree):
        """``fn`` on each shard of a Sharded tree (a Sharded back), or on
        a plain tree."""
        return tree.map(fn) if isinstance(tree, Sharded) else fn(tree)



def _pow2_at_least(n: int) -> int:
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _leading(tree) -> Optional[int]:
    leaves = [x for x in tree_leaves(tree) if x is not None]
    return leaves[0].shape[0] if leaves else None


def _stack(rows):
    """Rows of one key (trees of the same structure) -> a dense stack."""
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def _to(tree, device):
    """``tree``'s leaves on ``device`` (no copy for those already there)."""
    return tree_map(lambda x: x.to(device), tree)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _logical_bytes(tree) -> int:
    """The bytes of a stack counted once: a Group's replicated leaves
    once, its split leaves over every shard."""
    if not isinstance(tree, Group):
        return _tree_bytes(tree)
    paths = [p for p, _ in _rules.named_leaves(tree.shards[0])]
    per = [tree_leaves(s) for s in tree.shards]
    return sum(sum(lv[k].numel() * lv[k].element_size() for lv in
                   (per if tree.dims[p] is not None else per[:1]))
               for k, p in enumerate(paths))


def _row_dims(placement, row):
    """The model dims of one row (a Group's own when it has the plan's
    model-axis size)."""
    if isinstance(row, Group):
        if len(row) == placement.model_axis_size() and row.dims is not None:
            return row.dims
        row = join_group(row)
    return placement.model_dims(row, 0)


def _copy_row(dst, src):
    """``src`` (a plain row or a Group) written into the row view ``dst``
    in place: a Group destination takes each model shard of ``src``,
    every replicated leaf copied whole to each position (bit-equal)."""
    if isinstance(dst, Group):
        if isinstance(src, Group) and len(src) == len(dst):
            tree_map(lambda d, x: d.copy_(x), dst, src)
            return
        whole = join_group(src)
        paths = [p for p, _ in _rules.named_leaves(dst.shards[0])]
        leaves = tree_leaves(whole)
        for j, shard in enumerate(dst.shards):
            for p, d, x in zip(paths, tree_leaves(shard), leaves):
                d.copy_(_rules.split_leaf(x, dst.dims[p], len(dst), j))
        return
    tree_map(lambda d, x: d.copy_(x), dst, join_group(src))


def _clone_group_row(dst, src, jitter: float, generator):
    """``clone_slot`` over Group rows: each leaf copied shard by shard,
    then (floating leaves, ``jitter`` > 0) the noise of the whole leaf
    drawn once, in the one-device order, and added split like the leaf,
    so the replicated copies stay bit-equal and the draws are the
    one-device clone's."""
    m = len(dst)
    paths = [p for p, _ in _rules.named_leaves(dst.shards[0])]
    dl = [tree_leaves(s) for s in dst.shards]
    sl = [tree_leaves(s) for s in src.shards]
    with torch.no_grad():
        for k, p in enumerate(paths):
            dim = dst.dims[p]
            for j in range(m):
                dl[j][k].copy_(sl[j][k])
            first = dl[0][k]
            if not (jitter and first.is_floating_point()):
                continue
            shape = list(first.shape)
            if dim is not None:
                shape[dim] *= m
            noise = torch.randn(shape, generator=generator,
                                device=(first.device if generator is None
                                        else generator.device),
                                dtype=first.dtype)
            for j in range(m):
                part = _rules.split_leaf(noise, dim, m, j)
                dl[j][k].add_(part.to(dl[j][k].device), alpha=jitter)


def _pad(tree, n: int):
    """Append n zero rows on the leading axis of every leaf."""
    return tree_map(lambda x: torch.cat(
        [x, x.new_zeros((n,) + tuple(x.shape[1:]))]), tree)


class ParticleStore:
    """Canonical holder of all per-particle state of one PushDistribution.

    ``capacity`` preallocates slots (rounded up to a power of two) so the
    first ``capacity`` registrations never bump ``generation()``; 0 grows
    on demand (1, 2, 4, ... — one generation bump per doubling). Under a
    ``placement`` with a mesh the store's ``device`` is the first
    position's."""

    def __init__(self, capacity: int = 0, precision=None, device=None,
                 placement: Optional[Placement] = None):
        self.placement = placement if placement is not None else Placement()
        if self.placement.mesh is not None:
            device = self.placement.positions()[0]
        self.device = torch.device("cuda" if device is None else device)
        self.precision = _resolve_precision(precision)
        self.capacity = _pow2_at_least(capacity) if capacity > 0 else 0
        # rows stay on the device they were written on (a NEL device, or
        # pinned host memory under offload) instead of moving here
        self.keep_row_devices = False
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(self.capacity))   # min-heap
        self._activated: Set[int] = set()       # slots with data landed
        self._checkout_cohort: Dict[str, Any] = {}  # key -> (cap, slots)
        self._stacked: Dict[str, Any] = {}
        self._rows: Dict[str, Dict[int, Any]] = {}
        self._dirty: Dict[str, Set[int]] = {}
        self._present: Dict[str, Set[int]] = {}
        self._lock = threading.RLock()
        self._gen = 0
        self._versions: Dict[str, int] = {}
        self._mask_cache: Optional[torch.Tensor] = None
        self.stats = {"stacks": 0, "unstacks": 0, "row_flushes": 0,
                      "commits": 0, "device_puts": 0, "checkouts": 0,
                      "mask_invalidations": 0, "capacity_growths": 0,
                      "slot_clones": 0}

    # -- layout ----------------------------------------------------------------
    def _layout(self, n: Optional[int] = None):
        """``Placement.vector`` of ``n`` rows (the capacity by default):
        None when the stack is not split."""
        return self.placement.vector(self.capacity if n is None else n)

    def devices(self) -> List[torch.device]:
        """Every device the store's stacks live on (one per position)."""
        return self.placement.devices() or [self.device]

    def _fits(self, st, n: int) -> bool:
        """Whether a stacked tree has the layout of ``n`` rows."""
        layout = self._layout(n)
        if layout is None:
            return not isinstance(st, Sharded) and _leading(st) in (None, n)
        return (isinstance(st, Sharded) and len(st) == n
                and len(st.shards) == len(layout))

    def _place(self, tree, n: int):
        """A plain stacked tree of ``n`` rows onto the layout of ``n`` rows
        (one ``device_puts``), or a Sharded gathered back to one stack."""
        layout = self._layout(n)
        if isinstance(tree, Sharded):
            if layout is None:
                return tree.gather(self.device)
            return tree
        if layout is None or not tree_leaves(tree):
            return tree
        self.stats["device_puts"] += 1
        with _trace.span("store.h2d", "store", leaves=len(tree_leaves(tree))):
            return self.placement.split(tree, n)

    def _stack_rows(self, rows: List[Any]):
        """Rows of one key in slot order -> a stack on the layout of their
        count (each row moved to its position's device)."""
        layout = self._layout(len(rows))
        if layout is None:
            return _stack([_whole(r, self.device) for r in rows])
        self.stats["device_puts"] += 1
        pl = self.placement
        if pl.model_axis_size() <= 1:
            shards = [_stack([_whole(r, d) for r in rows[s]])
                      for _, d, s in layout]
        else:
            dims = _row_dims(pl, rows[0])
            shards = [_stack([pl.to_group(r, i, lead=0, dims=dims)
                              for r in rows[s]]) for i, _, s in layout]
        return Sharded(shards, [d for _, d, _ in layout], pl.plan_key())

    # -- registry / slot allocation ------------------------------------------
    @property
    def pids(self) -> List[int]:
        """Live pids in slot order."""
        with self._lock:
            return [pid for pid, _ in
                    sorted(self._slot_of.items(), key=lambda kv: kv[1])]

    def slot_of(self, pid: int) -> int:
        with self._lock:
            return self._slot_of[pid]

    def __len__(self) -> int:
        return len(self._slot_of)

    def live_count(self) -> int:
        with self._lock:
            return len(self._slot_of)

    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def live_slots(self) -> List[int]:
        """Sorted activated slots (host-side; no device sync)."""
        with self._lock:
            return sorted(self._activated)

    def register(self, pid: int) -> int:
        """Allocate a slot for ``pid`` (a freed one when possible; grow to
        the next power of two — a generation bump — only when full). The
        slot goes live in ``active_mask()`` when its first data lands."""
        with self._lock:
            if pid in self._slot_of:
                raise ValueError(f"pid {pid} already registered")
            if not self._free:
                self._grow(_pow2_at_least(self.capacity + 1))
            slot = heapq.heappop(self._free)
            self._slot_of[pid] = slot
            for _, cohort_slots in self._checkout_cohort.values():
                cohort_slots.discard(slot)
            return slot

    def unregister(self, pid: int) -> int:
        """Free ``pid``'s slot; the stale row stays in the stacked tensors,
        masked out, so unregister never restacks or bumps the generation."""
        with self._lock:
            slot = self._slot_of.pop(pid)   # KeyError for unknown pid
            heapq.heappush(self._free, slot)
            self._activated.discard(slot)
            for present in self._present.values():
                present.discard(slot)
            for rows in self._rows.values():
                rows.pop(slot, None)
            for dirty in self._dirty.values():
                dirty.discard(slot)
            self._invalidate_mask()
            return slot

    def _grow(self, new_capacity: int):
        """Pad every stacked tree to the new capacity (lock held) — the one
        lifecycle operation that changes stacked shapes. When the old or
        the new capacity is split over a mesh, the slots change position:
        each stack becomes rows (views of it) that the next flush
        restacks on the new layout."""
        old, self.capacity = self.capacity, new_capacity
        for s in range(old, new_capacity):
            heapq.heappush(self._free, s)
        relayout = (self._layout(old) is not None
                    or self._layout(new_capacity) is not None)
        for key, st in list(self._stacked.items()):
            if relayout and tree_leaves(st if not isinstance(st, Sharded)
                                        else st.shards[0]):
                self._to_rows(key, st, clone=False)
            elif not isinstance(st, Sharded):
                self._stacked[key] = _pad(st, new_capacity - old)
        self._gen += 1
        self.stats["capacity_growths"] += 1
        _trace.instant("store.generation_bump", "store",
                       capacity=new_capacity, generation=self._gen)
        self._invalidate_mask()

    def _to_rows(self, key: str, st, clone: bool):
        """Replace ``key``'s stacked form by per-slot rows of it (lock
        held): views, or independent copies with ``clone``. Rows already
        pending stay."""
        rows = self._rows.setdefault(key, {})
        n = 0
        for slot in sorted(self._present.get(key, ())):
            if slot in rows:
                continue
            row = (st.row(slot) if isinstance(st, Sharded)
                   else tree_map(lambda x, slot=slot: x[slot], st))
            rows[slot] = tree_map(torch.clone, row) if clone else row
            n += 1
        self.stats["unstacks"] += n
        self._stacked.pop(key, None)
        self._dirty[key] = set()

    def demote(self, key: str) -> bool:
        """Drop ``key``'s stacked form for independent per-slot rows (one
        copy each), so that moving a row elsewhere (offload) frees its
        memory; the next flush restacks. False when the key is not stacked
        (nothing to do) or is checked out."""
        with self._lock:
            st = self._stacked.get(key)
            if st is None or key in self._checkout_cohort:
                return False
            self._to_rows(key, st, clone=True)
            self._bump(key)
            return True

    # -- active mask / versions ----------------------------------------------
    def _invalidate_mask(self):
        self._mask_cache = None
        self.stats["mask_invalidations"] += 1

    def active_mask(self) -> torch.Tensor:
        """``(capacity,)`` float32 mask on the store's device (the first
        position's under a mesh), 1.0 at activated slots; cached between
        lifecycle events. A program over a sharded stack takes each
        position's slice of it."""
        with self._lock:
            if self._mask_cache is None:
                m = torch.zeros(self.capacity, dtype=torch.float32)
                m[sorted(self._activated)] = 1.0
                self._mask_cache = m.to(self.device)
            return self._mask_cache

    def snapshot(self, key: str):
        """(version, active mask, canonical stacked tree), read atomically."""
        with self._lock:
            return ((self._gen, self._versions.get(key, 0)),
                    self.active_mask(), self._flush(key))

    def version(self, key: str):
        """Token that changes whenever ``key``'s canonical content could."""
        with self._lock:
            return (self._gen, self._versions.get(key, 0))

    def generation(self) -> int:
        """Bumps only on capacity growth, a new state key or a reshard."""
        with self._lock:
            return self._gen

    def _bump(self, key: str):
        self._versions[key] = self._versions.get(key, 0) + 1

    def keys(self) -> List[str]:
        """Every state key any particle holds (stacked or row form)."""
        with self._lock:
            return sorted(set(self._present) | set(self._stacked))

    def _subset(self, pids: Optional[Sequence[int]]) -> Optional[List[int]]:
        """None -> the canonical capacity-padded path. An explicit pid list
        keeps the dense "index i <-> pids[i]" contract; it collapses onto
        the canonical path only when that is the same thing (the full live
        set in slot order, no free slot). Unregistered pids raise
        KeyError (lock held)."""
        if pids is None:
            return None
        pids = list(pids)
        if pids == self.pids and len(pids) == self.capacity:
            return None
        missing = [p for p in pids if p not in self._slot_of]
        if missing:
            raise KeyError(f"unregistered pids {missing}")
        return pids

    def _mark_present(self, key: str, slot: int):
        present = self._present.get(key)
        if present is None:
            present = self._present[key] = set()
            if key not in self._stacked:
                self._gen += 1      # key-schema change
        present.add(slot)
        if slot not in self._activated:
            self._activated.add(slot)
            self._invalidate_mask()

    # -- per-particle views --------------------------------------------------
    def _read_slot(self, key: str, slot: int):
        rows = self._rows.get(key, {})
        if slot in rows:
            return rows[slot]
        if key not in self._stacked or slot not in self._present.get(key, ()):
            raise KeyError(f"store has no {key!r} in slot {slot}")
        self.stats["unstacks"] += 1
        st = self._stacked[key]
        if isinstance(st, Sharded):
            return st.row(slot)
        return tree_map(lambda x: x[slot], st)

    def read(self, key: str, pid: int):
        """View of one particle's entry (no copy); under a model axis its
        model shards joined on the store's device (a copy of each split
        leaf)."""
        with self._lock:
            row = self._read_slot(key, self._slot_of[pid])
        return join_group(row, self.device) if isinstance(row, Group) \
            else row

    def is_stacked(self, key: str) -> bool:
        with self._lock:
            return key in self._stacked

    def has(self, key: str, pid: int) -> bool:
        with self._lock:
            return self._slot_of[pid] in self._present.get(key, ())

    def keys_for(self, pid: int) -> List[str]:
        """State keys holding an entry for ``pid``."""
        with self._lock:
            slot = self._slot_of[pid]
            return [k for k, present in self._present.items()
                    if slot in present]

    def write(self, key: str, pid: int, tree):
        """Write-back: the row shadows the stacked entry until the next
        flush. Leaves move to the store's device (a ``store.h2d`` span when
        they come from elsewhere), unless ``keep_row_devices`` is set."""
        if not self.keep_row_devices and any(
                x.device != self.device for x in tree_leaves(tree)):
            with _trace.span("store.h2d", "store", key=key):
                tree = tree_map(lambda x: x.to(self.device), tree)
        with self._lock:
            self._write_row(key, self._slot_of[pid], tree)
            self._bump(key)

    def _write_row(self, key: str, slot: int, tree):
        """A dirty row that shadows the stacked entry (lock held)."""
        self._mark_present(key, slot)
        self._rows.setdefault(key, {})[slot] = tree
        self._dirty.setdefault(key, set()).add(slot)

    def discard(self, key: str, pid: int):
        """Drop ``pid``'s row of a row-only key (a stacked key would no
        longer cover the pid: ValueError)."""
        with self._lock:
            if key in self._stacked:
                raise ValueError(
                    f"cannot delete {key!r} of particle {pid}: the key is "
                    "stacked; delete is only supported for row-only keys")
            slot = self._slot_of[pid]
            rows = self._rows.get(key, {})
            if slot not in rows:
                raise KeyError(key)
            del rows[slot]
            self._present.get(key, set()).discard(slot)
            self._dirty.get(key, set()).discard(slot)
            self._bump(key)

    # -- canonical stacked form ----------------------------------------------
    def _flush(self, key: str):
        """Make the capacity-padded stacked tree canonical (lock held):
        dirty rows copied into their stack (their shard, under a mesh) in
        place, or a full restack on the capacity's layout."""
        st = self._stacked.get(key)
        dirty = self._dirty.get(key, set())
        cap = self.capacity
        if st is not None and self._fits(st, cap):
            rows = self._rows.get(key, {})
            for slot in sorted(dirty):
                dst = (st.row(slot) if isinstance(st, Sharded)
                       else tree_map(lambda x, slot=slot: x[slot], st))
                _copy_row(dst, rows.pop(slot))
            self.stats["row_flushes"] += len(dirty)
        else:
            present = sorted(self._present.get(key, ()))
            if not present:
                raise KeyError(key)
            rows = {s: self._read_slot(key, s) for s in present}
            template = rows[present[0]]
            if not tree_leaves(template):
                st = template
            else:
                zero = tree_map(lambda x: torch.zeros_like(
                    x, device=self.device), template)
                st = self._stack_rows([rows.get(s, zero)
                                       for s in range(cap)])
            self._rows.pop(key, None)     # rows are views of st from now on
            self.stats["stacks"] += 1
        self._stacked[key] = st
        self._dirty[key] = set()
        return st

    def _dense_rows(self, key: str, pids: Sequence[int]):
        """A fresh dense stack of ``pids``' rows, index i <-> pids[i], on
        the layout of their count (lock held)."""
        self.stats["stacks"] += 1
        return self._stack_rows([self._read_slot(key, self._slot_of[p])
                                 for p in pids])

    def stacked(self, key: str, pids: Optional[Sequence[int]] = None):
        """The canonical capacity-padded stacked tree (flushing first);
        consumers combine it with ``active_mask()``. With a pid subset, a
        fresh dense stack of those rows that leaves the canonical form
        alone."""
        with self._lock:
            sub = self._subset(pids)
            if sub is None:
                return self._flush(key)
            return self._dense_rows(key, sub)

    def dense(self, key: str, pids: Optional[Sequence[int]] = None):
        """Live rows only (or ``pids``' rows, in that order), stacked dense
        (leading dim = their count) on the store's device: for consumers
        that must never see a padding slot (serve-time SWAG sampling).
        With every slot live on one device this is the canonical stacked
        tree itself, not a copy. A pid whose slot holds no ``key`` (a
        fresh particle in a killed one's slot, whose stale row is still
        stacked) raises KeyError, as ``read`` does."""
        with self._lock:
            live = pids is None
            pids = self.pids if live else list(pids)
            present = self._present.get(key, ())
            for p in pids:
                if self._slot_of[p] not in present:
                    raise KeyError(f"store has no {key!r} for particle {p}")
            st = self._flush(key)
            slots = [self._slot_of[p] for p in pids]
            if isinstance(st, Sharded):
                self.stats["stacks"] += 1
                return _stack([_whole(st.row(s), self.device) for s in slots])
            if live and len(slots) == self.capacity:
                return st
            self.stats["stacks"] += 1
            idx = torch.tensor(slots, device=self.device)
            return tree_map(lambda x: x.index_select(0, idx), st)

    def checkout(self, key: str, pids: Optional[Sequence[int]] = None):
        """Flush and hand the stacked tree to the caller, who must
        ``commit`` it (or its update) back. With a pid subset the caller
        gets a fresh dense stack of those rows and the store keeps the
        canonical tensors (module doc)."""
        with _trace.span("store.checkout", "store", key=key), self._lock:
            sub = self._subset(pids)
            self.stats["checkouts"] += 1
            self._bump(key)
            if sub is not None:
                return self._dense_rows(key, sub)
            st = self._flush(key)
            self._checkout_cohort[key] = (
                self.capacity, set(self._present.get(key, ())))
            self._stacked.pop(key, None)
            self._rows.pop(key, None)
            self._dirty.pop(key, None)
            return st

    def commit(self, key: str, stacked,
               pids: Optional[Sequence[int]] = None):
        """``stacked`` becomes canonical for ``key``. After a checkout it
        covers the slots checked out (padded if the store grew meanwhile);
        a direct commit speaks for every live slot, and a plain tree
        committed to a store split over a mesh is placed onto it (one
        ``device_puts``). With a pid subset, row i of ``stacked`` becomes
        pids[i]'s dirty row, which the next flush copies into the
        canonical tensors in place."""
        with _trace.span("store.commit", "store", key=key), self._lock:
            sub = self._subset(pids)
            cohort = None if sub is not None \
                else self._checkout_cohort.pop(key, None)
            if sub is not None:
                n = len(sub)
            else:
                n = cohort[0] if cohort is not None else self.capacity
            lead = (len(stacked) if isinstance(stacked, Sharded)
                    else _leading(stacked))
            if lead not in (None, n):     # None: a leafless tree
                raise ValueError(f"stacked {key!r} has leading dim "
                                 f"{lead}, expected {n}")
            self.stats["commits"] += 1
            self._bump(key)
            if sub is not None:
                for j, pid in enumerate(sub):
                    row = (stacked.row(j) if isinstance(stacked, Sharded)
                           else tree_map(lambda x, j=j: x[j], stacked))
                    self._write_row(key, self._slot_of[pid], row)
                self.stats["unstacks"] += len(sub)
                return
            if cohort is None:
                if key not in self._present and key not in self._stacked:
                    self._gen += 1     # key-schema change
                self._stacked[key] = self._place(stacked, n)
                for slot in self._slot_of.values():
                    self._mark_present(key, slot)
                self._rows.pop(key, None)
                self._dirty.pop(key, None)
                return
            co_cap, co_slots = cohort
            rows = self._rows.get(key, {})
            dirty = self._dirty.get(key, set())
            for slot in co_slots:
                rows.pop(slot, None)
                dirty.discard(slot)
            self._present.setdefault(key, set()).update(
                co_slots & set(self._slot_of.values()))
            if co_cap < self.capacity and (
                    isinstance(stacked, Sharded)
                    or self._layout() is not None):
                # the store grew under the run onto another layout: the
                # run's rows become pending rows, restacked at next flush
                self._to_rows(key, stacked, clone=False)
                self._dirty[key] = dirty
                return
            if co_cap < self.capacity:
                stacked = _pad(stacked, self.capacity - co_cap)
            self._stacked[key] = stacked

    # -- fused slot cloning (the p_clone path) -------------------------------
    def clone_slot(self, key: str, src_pid: int, dst_pid: int,
                   jitter: float = 0.0, generator=None):
        """Copy ``key``'s row of ``src_pid``'s slot into ``dst_pid``'s slot
        inside the canonical stacked tensors, one ``copy_`` per leaf (from
        one position's shard into another's under a mesh), with ``jitter``
        times N(0, 1) from ``generator`` added in place to the floating
        leaves. Every stacked tensor keeps its address, so a step captured
        on them needs no new capture, and the next flush is a no-op. A
        leafless tree (``grads`` None) is copied as a row.

        The copy is eager for every key: the reference's lazy row copy
        (``prefer_row``) would here be a view of the source's row, which
        changes as the source trains on. Raises RuntimeError while the key
        is checked out by a fused run (its tensors are in the run's
        hands), KeyError when the source holds no ``key``."""
        with self._lock:
            src = self._slot_of[src_pid]
            dst = self._slot_of[dst_pid]
            if key in self._checkout_cohort:
                raise RuntimeError(
                    f"{key!r} is checked out by an in-flight fused run; "
                    "commit it back before cloning")
            if src not in self._present.get(key, ()):
                raise KeyError(f"store has no {key!r} for particle "
                               f"{src_pid}")
            st = self._flush(key)
            if isinstance(st, Sharded):
                src_row, dst_row = st.row(src), st.row(dst)
            else:
                src_row = tree_map(lambda x: x[src], st)
                dst_row = tree_map(lambda x: x[dst], st)
            pairs = list(zip(tree_leaves(dst_row), tree_leaves(src_row)))
            if not pairs:
                self._write_row(key, dst, self._read_slot(key, src))
            elif isinstance(dst_row, Group):
                _clone_group_row(dst_row, src_row, jitter, generator)
                self._mark_present(key, dst)
                self.stats["slot_clones"] += 1
            else:
                with torch.no_grad():
                    for row, from_row in pairs:
                        row.copy_(from_row)
                        if jitter and row.is_floating_point():
                            noise = torch.randn(
                                row.shape, generator=generator,
                                device=(row.device if generator is None
                                        else generator.device),
                                dtype=row.dtype)
                            row.add_(noise.to(row.device), alpha=jitter)
                self._mark_present(key, dst)
                self.stats["slot_clones"] += 1
            self._bump(key)

    # -- lifecycle introspection -----------------------------------------
    def rebalance(self):
        """The store half of ``pd.p_rebalance()``: flush every key onto
        the current layout (a key stacked on another layout is restacked)
        and rebuild the mask."""
        with self._lock:
            for key in self.keys():
                if key in self._checkout_cohort:
                    continue
                st = self._stacked.get(key)
                if st is not None and not self._fits(st, self.capacity):
                    self._to_rows(key, st, clone=False)
                try:
                    self._flush(key)
                except KeyError:
                    continue
            self._invalidate_mask()

    def reshard(self, placement: Placement):
        """Move every key onto ``placement`` (another mesh, or one device
        with ``mesh=None``): each stack becomes rows that are restacked at
        once on the new layout (``device_puts`` counts the placements onto
        a mesh), as capacity growth re-lays the slots out. Every address
        changes, so ``generation()`` bumps. RuntimeError while a fused run
        holds a key."""
        with self._lock:
            if placement == self.placement:
                return
            if self._checkout_cohort:
                raise RuntimeError(
                    f"{sorted(self._checkout_cohort)} checked out by an "
                    "in-flight fused run; commit it back before resharding")
            for key, st in list(self._stacked.items()):
                if tree_leaves(st.shards[0] if isinstance(st, Sharded)
                               else st):
                    self._to_rows(key, st, clone=False)
            self.placement = placement
            if placement.mesh is not None:
                self.device = placement.positions()[0]
            self._gen += 1
            _trace.instant("store.generation_bump", "store",
                           capacity=self.capacity, generation=self._gen)
            self._invalidate_mask()
            for key in self.keys():
                if key in self._rows:
                    self._flush(key)

    def per_particle_bytes(self, key: str = "params") -> int:
        """Bytes of ``key`` per slot (the stacked tree over capacity, or
        one row), actual leaf dtypes; 0 when the store holds no ``key``."""
        with self._lock:
            tree = self._stacked.get(key)
            if tree is None:
                rows = self._rows.get(key, {})
                if not rows:
                    return 0
                return _tree_bytes(next(iter(rows.values())))
            total = (sum(_logical_bytes(s) for s in tree.shards)
                     if isinstance(tree, Sharded) else _tree_bytes(tree))
            return total // max(self.capacity, 1)

    def lifecycle_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity,
                    "live": len(self._slot_of),
                    "free_slots": len(self._free),
                    "generation": self._gen,
                    "mask_invalidations": self.stats["mask_invalidations"],
                    "capacity_growths": self.stats["capacity_growths"]}

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    # -- introspection -------------------------------------------------------
    def key_dtypes(self, key: str) -> Dict[str, int]:
        """{dtype name: leaf count} of ``key``'s resident state."""
        out: Dict[str, int] = {}
        with self._lock:
            tree = self._stacked.get(key)
            if isinstance(tree, Sharded):
                tree = tree.shards[0]
            if isinstance(tree, Group):
                tree = tree.shards[0]
            if tree is None:
                rows = self._rows.get(key, {})
                tree = next(iter(rows.values()), None)
            for leaf in tree_leaves(tree) if tree is not None else ():
                name = str(leaf.dtype).replace("torch.", "")
                out[name] = out.get(name, 0) + 1
        return out

    def per_device_bytes(self, key: str = "params") -> int:
        """Bytes of ``key``'s state resident on one device: the canonical
        stacked tree (its largest position's shard under a mesh, a model
        shard under a model axis), or the rows when none is stacked.
        Reads without flushing or counting; 0 when the store holds
        nothing for ``key``."""
        with self._lock:
            tree = self._stacked.get(key)
            if isinstance(tree, Sharded):
                return max(_bytes_per_device(s) for s in tree.shards)
            if tree is not None:
                return _tree_bytes(tree)
            return sum(_tree_bytes(t)
                       for t in self._rows.get(key, {}).values())


# ---------------------------------------------------------------------------
# per-particle mapping facade (what Particle.state is)
# ---------------------------------------------------------------------------

class StoreState:
    """Mutable-mapping view of one particle's slice of a ParticleStore.

    ``particle.state["params"]`` reads through ``store.read`` (a view of
    the stacked tensor, or the particle's pending row) and writes through
    ``store.write`` (a dirty row, versioned), so the NEL backend and the
    fused backend observe one source of truth. A handler that updates a
    read tree in place writes it back through ``state[key] = tree`` so
    the store's version and dirty tracking see the change."""

    def __init__(self, store: ParticleStore, pid: int):
        self.store = store
        self.pid = pid

    def __getitem__(self, key: str):
        return self.store.read(key, self.pid)

    def __setitem__(self, key: str, value):
        self.store.write(key, self.pid, value)

    def __delitem__(self, key: str):
        self.store.discard(key, self.pid)

    def __contains__(self, key: str) -> bool:
        return self.store.has(key, self.pid)

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return self.store.keys_for(self.pid)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __repr__(self) -> str:
        return f"StoreState(pid={self.pid}, keys={sorted(self.keys())})"
