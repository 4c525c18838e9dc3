"""ParticleStore: the single source of truth for per-particle state.

Counterpart of ``repro.core.store`` on one device: ``Placement`` is the
reference's plan record with its single-device plan only (a mesh waits
for multi-GPU placement, ROADMAP.md queue 1 item 10).
``StoreState`` is one particle's mapping view of it (``particle.state``).

  * canonical form — one *stacked* tree per state key ("params",
    "kv_pages", ...) with a leading particle axis, on ``device``;
  * derived form — per-particle *views* (``leaf[slot]``, no copy) with
    dirty-tracked write-back.

Elastic lifecycle (DESIGN.md §9): the store allocates by **capacity, not
count**. Stacked trees are padded to a power-of-two ``capacity``; each
live particle owns a *slot*, freed slots go on a free list, and
``active_mask()`` (shape ``(capacity,)``, 1.0 at live slots) tells fused
steps which rows are real. ``generation()`` bumps only on capacity growth
or a key seen for the first time, never on churn within capacity:
``clone_slot`` copies one slot's rows into another inside the stacked
tensors (``copy_``, jitter added in place), and ``unregister`` flips the
mask, so both keep every stacked tensor at its address and a step
captured on those addresses (``runtime.program``) stays valid. Capacity
growth (``_grow``, ``torch.cat``) is the one event that moves them.

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

``stats`` keeps the reference's counters: ``unstacks`` counts rows sliced
out of a stacked tree (a read of a stacked row, a subset commit's rows),
``device_puts`` re-placements onto a mesh (0 on one device, as the
reference's with ``mesh=None``). Spans (DESIGN.md §12, cat ``store``):
``store.checkout``, ``store.commit``, ``store.h2d`` around a write whose
leaves come from the host, and the ``store.generation_bump`` instant at
capacity growth.
"""
from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from ..obs import trace as _trace
from .precision import get as _resolve_precision
from .tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Placement:
    """The reference's placement plan (``repro.core.store.Placement``) on
    one device: ``mesh=None`` keeps every particle on the store's device,
    so the particle and model axes have size 1. A mesh raises until
    multi-GPU placement is ported (ROADMAP.md queue 1 item 10)."""
    mesh: Any = None
    particle_axis: Optional[str] = "data"
    mode: str = "tp"
    model_axis: Optional[str] = "model"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port's ParticleStore keeps every particle on one "
                "device; a placement mesh waits for multi-GPU placement "
                "(ROADMAP.md, queue 1 item 10)")

    def model_axis_size(self) -> int:
        return 1


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


def _pad(tree, n: int):
    """Append n zero rows on the leading axis of every leaf."""
    return tree_map(lambda x: torch.cat(
        [x, x.new_zeros((n,) + tuple(x.shape[1:]))]), tree)


class ParticleStore:
    """Canonical holder of all per-particle state of one PushDistribution.

    ``capacity`` preallocates slots (rounded up to a power of two) so the
    first ``capacity`` registrations never bump ``generation()``; 0 grows
    on demand (1, 2, 4, ... — one generation bump per doubling)."""

    def __init__(self, capacity: int = 0, precision=None, device=None,
                 placement: Optional[Placement] = None):
        self.placement = placement if placement is not None else Placement()
        self.device = torch.device("cuda" if device is None else device)
        self.precision = _resolve_precision(precision)
        self.capacity = _pow2_at_least(capacity) if capacity > 0 else 0
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
        lifecycle operation that changes stacked shapes."""
        old, self.capacity = self.capacity, new_capacity
        for s in range(old, new_capacity):
            heapq.heappush(self._free, s)
        for key, st in list(self._stacked.items()):
            self._stacked[key] = _pad(st, new_capacity - old)
        self._gen += 1
        self.stats["capacity_growths"] += 1
        _trace.instant("store.generation_bump", "store",
                       capacity=new_capacity, generation=self._gen)
        self._invalidate_mask()

    # -- active mask / versions ----------------------------------------------
    def _invalidate_mask(self):
        self._mask_cache = None
        self.stats["mask_invalidations"] += 1

    def active_mask(self) -> torch.Tensor:
        """``(capacity,)`` float32 mask on the store's device, 1.0 at
        activated slots; cached between lifecycle events."""
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
        """Bumps only on capacity growth or a new state key."""
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
        return tree_map(lambda x: x[slot], self._stacked[key])

    def read(self, key: str, pid: int):
        """View of one particle's entry (no copy)."""
        with self._lock:
            return self._read_slot(key, self._slot_of[pid])

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
        they come from elsewhere)."""
        if any(x.device != self.device for x in tree_leaves(tree)):
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
        """Make the capacity-padded stacked tree canonical (lock held)."""
        st = self._stacked.get(key)
        dirty = self._dirty.get(key, set())
        cap = self.capacity
        if st is not None and _leading(st) == cap:
            rows = self._rows.get(key, {})
            for slot in sorted(dirty):
                tree_map(lambda s, r, slot=slot: s[slot].copy_(r), st,
                         rows.pop(slot))
            self.stats["row_flushes"] += len(dirty)
        else:
            present = sorted(self._present.get(key, ()))
            if not present:
                raise KeyError(key)
            rows = {s: self._read_slot(key, s) for s in present}
            template = rows[present[0]]
            st = tree_map(
                lambda t, *rs: torch.stack(list(rs)),
                template, *[rows.get(s) if s in rows
                            else tree_map(torch.zeros_like, template)
                            for s in range(cap)])
            self._rows.pop(key, None)     # rows are views of st from now on
            self.stats["stacks"] += 1
        self._stacked[key] = st
        self._dirty[key] = set()
        return st

    def _dense_rows(self, key: str, pids: Sequence[int]):
        """A fresh dense stack of ``pids``' rows, index i <-> pids[i]
        (lock held)."""
        self.stats["stacks"] += 1
        return _stack([self._read_slot(key, self._slot_of[p]) for p in pids])

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
        (leading dim = their count): for consumers that must never see a
        padding slot (serve-time SWAG sampling). With every slot live this
        is the canonical stacked tree itself, not a copy. A pid whose slot
        holds no ``key`` (a fresh particle in a killed one's slot, whose
        stale row is still stacked) raises KeyError, as ``read`` does."""
        with self._lock:
            live = pids is None
            pids = self.pids if live else list(pids)
            present = self._present.get(key, ())
            for p in pids:
                if self._slot_of[p] not in present:
                    raise KeyError(f"store has no {key!r} for particle {p}")
            st = self._flush(key)
            slots = [self._slot_of[p] for p in pids]
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
        a direct commit speaks for every live slot. With a pid subset, row
        i of ``stacked`` becomes pids[i]'s dirty row, which the next flush
        copies into the canonical tensors in place."""
        with _trace.span("store.commit", "store", key=key), self._lock:
            sub = self._subset(pids)
            cohort = None if sub is not None \
                else self._checkout_cohort.pop(key, None)
            if sub is not None:
                n = len(sub)
            else:
                n = cohort[0] if cohort is not None else self.capacity
            if _leading(stacked) not in (None, n):     # None: a leafless tree
                raise ValueError(f"stacked {key!r} has leading dim "
                                 f"{_leading(stacked)}, expected {n}")
            self.stats["commits"] += 1
            self._bump(key)
            if sub is not None:
                for j, pid in enumerate(sub):
                    self._write_row(key, self._slot_of[pid],
                                    tree_map(lambda x, j=j: x[j], stacked))
                self.stats["unstacks"] += len(sub)
                return
            if cohort is None:
                if key not in self._present and key not in self._stacked:
                    self._gen += 1     # key-schema change
                self._stacked[key] = stacked
                for slot in self._slot_of.values():
                    self._mark_present(key, slot)
                self._rows.pop(key, None)
                self._dirty.pop(key, None)
                return
            co_cap, co_slots = cohort
            if co_cap < self.capacity:
                stacked = _pad(stacked, self.capacity - co_cap)
            self._stacked[key] = stacked
            self._present.setdefault(key, set()).update(
                co_slots & set(self._slot_of.values()))
            rows = self._rows.get(key, {})
            dirty = self._dirty.get(key, set())
            for slot in co_slots:
                rows.pop(slot, None)
                dirty.discard(slot)

    # -- fused slot cloning (the p_clone path) -------------------------------
    def clone_slot(self, key: str, src_pid: int, dst_pid: int,
                   jitter: float = 0.0, generator=None):
        """Copy ``key``'s row of ``src_pid``'s slot into ``dst_pid``'s slot
        inside the canonical stacked tensors, one ``copy_`` per leaf, with
        ``jitter`` times N(0, 1) from ``generator`` added in place to the
        floating leaves. Every stacked tensor keeps its address, so a step
        captured on them needs no new capture, and the next flush is a
        no-op. A leafless tree (``grads`` None) is copied as a row.

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
            leaves = tree_leaves(st)
            if not leaves:
                self._write_row(key, dst, self._read_slot(key, src))
            else:
                with torch.no_grad():
                    for leaf in leaves:
                        row = leaf[dst]
                        row.copy_(leaf[src])
                        if jitter and leaf.is_floating_point():
                            row.add_(torch.randn(
                                row.shape, generator=generator,
                                device=leaf.device, dtype=leaf.dtype),
                                alpha=jitter)
                self._mark_present(key, dst)
                self.stats["slot_clones"] += 1
            self._bump(key)

    # -- lifecycle introspection -----------------------------------------
    def rebalance(self):
        """The store half of ``pd.p_rebalance()``: flush every key and
        rebuild the mask. On one device there is nothing to re-place (the
        reference re-places each key against its mesh ``Placement``)."""
        with self._lock:
            for key in self.keys():
                try:
                    self._flush(key)
                except KeyError:
                    continue
            self._invalidate_mask()

    def per_particle_bytes(self, key: str = "params") -> int:
        """Bytes of ``key`` per slot (the stacked tree over capacity, or
        one row), actual leaf dtypes; 0 when the store holds no ``key``."""
        with self._lock:
            tree = self._stacked.get(key)
            if tree is None:
                rows = self._rows.get(key, {})
                if not rows:
                    return 0
                return sum(x.numel() * x.element_size()
                           for x in tree_leaves(next(iter(rows.values()))))
            total = sum(x.numel() * x.element_size()
                        for x in tree_leaves(tree))
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
            if tree is None:
                rows = self._rows.get(key, {})
                tree = next(iter(rows.values()), None)
            for leaf in tree_leaves(tree) if tree is not None else ():
                name = str(leaf.dtype).replace("torch.", "")
                out[name] = out.get(name, 0) + 1
        return out

    def per_device_bytes(self, key: str = "params") -> int:
        """Bytes of ``key``'s state resident on the store's one device:
        the canonical stacked tree, or the rows when none is stacked. Reads
        without flushing or counting; 0 when the store holds nothing for
        ``key``."""
        with self._lock:
            tree = self._stacked.get(key)
            trees = [tree] if tree is not None \
                else list(self._rows.get(key, {}).values())
            return sum(x.numel() * x.element_size()
                       for t in trees for x in tree_leaves(t))


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
