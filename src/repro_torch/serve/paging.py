"""Paged KV-cache pool over the particle axis (DESIGN.md §10).

Counterpart of ``repro.serve.paging``. The device side is ONE
ParticleStore key (``"kv_pages"``): every attention layer's K/V state
lives in a fixed pool of fixed-size pages — per particle,
``(num_pages, page_size, KVH, hd)`` per layer — stacked over the store's
capacity axis like params. Decode steps update the pool in place.

The host side is a free-page allocator plus per-sequence block tables, so
page allocation and reclaim are pure host metadata: handing a page from a
finished sequence to a new one changes two Python lists and the next
step's block-table upload, never the device tree.

Block-table conventions (shared with kernels/paged_decode_attention.py):
rows are ``(max_seq_pages,)`` int32, logical page i of a sequence at
entry i, unused entries 0 (in bounds, masked by seq_len).

The scratch page: ``models.api.paged_cache_init`` makes the device pool
one page larger than the ``num_pages`` a PagePool of the same size hands
out, and ``models.api.scratch_page`` names that page. It takes the KV
writes the reference drops (inactive rows, window positions past a row's
window, prompt padding), so every step writes at fixed shapes with no
host sync (``models.blocks.paged_write_index``). No block table names
it, so no kernel reads it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.store import Sharded
from ..core.tree import Group, tree_flatten, tree_map
from ..sharding.rules import named_leaves, split_leaf


def create_kv_pages(store, make_pages: Callable, *, key: str = "kv_pages",
                    dtype=None):
    """Install the stacked page pool as a store key.

    ``make_pages(device=...)`` builds ONE particle's page tree (e.g. a partial
    of ``models.api.paged_cache_init``); it is called on the ``meta``
    device for shapes only, and the pool is allocated once, zeroed, with
    the store's capacity as leading axis. ``dtype=`` overrides the storage
    dtype of every floating page leaf. Under a mesh each position's
    pages are allocated on its device; under a model axis each position
    of a model group holds its kv heads (the ``(^|/)(k|v)$`` rule), or
    every head when the axis does not divide them. This is the one
    generation bump of the paged path (a new key) — do it before serving
    warmup."""
    shapes = make_pages(device=torch.device("meta"))

    def alloc(s, n, device):
        dt = dtype if dtype is not None and s.dtype.is_floating_point \
            else s.dtype
        return torch.zeros((n,) + tuple(s.shape), dtype=dt, device=device)

    pl = store.placement
    layout = pl.vector(store.capacity)
    if layout is None:
        pool = tree_map(lambda s: alloc(s, store.capacity, store.device),
                        shapes)
    elif pl.model_axis_size() > 1:
        dims = pl.model_dims(shapes, lead=0)
        leaves, unflatten = tree_flatten(shapes)
        paths = [p for p, _ in named_leaves(shapes)]
        groups = []
        for i, _, sl in layout:
            devs = pl.groups()[i]
            groups.append(Group([unflatten([
                alloc(split_leaf(s, dims[p], len(devs), j),
                      sl.stop - sl.start, d)
                for p, s in zip(paths, leaves)])
                for j, d in enumerate(devs)], dims, devs))
        pool = Sharded(groups, [d for _, d, _ in layout], pl.plan_key())
    else:
        # each position's pages on its device, allocated there
        pool = Sharded([tree_map(lambda s, n=sl.stop - sl.start, d=d:
                                 alloc(s, n, d), shapes)
                        for _, d, sl in layout], [d for _, d, _ in layout],
                       store.placement.plan_key())
    store.commit(key, pool)
    return key


class PagePool:
    """Host-side free-page allocator + per-sequence page lists.

    Thread-safe; never touches the device. ``alloc`` returns None rather
    than blocking when the pool is dry — the scheduler turns that into
    admission backpressure or preemption."""

    def __init__(self, num_pages: int, page_size: int, max_seq_pages: int):
        if num_pages < 1 or page_size < 1 or max_seq_pages < 1:
            raise ValueError("num_pages, page_size, max_seq_pages must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seq_pages = max_seq_pages
        self._lock = threading.Lock()
        self._free: deque = deque(range(num_pages))
        self._owned: Dict[int, List[int]] = {}      # seq id -> page ids
        self.stats = {"allocs": 0, "releases": 0, "alloc_failures": 0,
                      "peak_used": 0}

    def alloc(self, seq_id: int, n: int = 1) -> Optional[List[int]]:
        """Append ``n`` pages to ``seq_id``'s list; None if the pool has
        fewer than ``n`` free pages or the sequence would exceed
        ``max_seq_pages`` (callers treat both as backpressure)."""
        with self._lock:
            owned = self._owned.setdefault(seq_id, [])
            if len(self._free) < n or len(owned) + n > self.max_seq_pages:
                self.stats["alloc_failures"] += 1
                return None
            got = [self._free.popleft() for _ in range(n)]
            owned.extend(got)
            self.stats["allocs"] += n
            used = self.num_pages - len(self._free)
            if used > self.stats["peak_used"]:
                self.stats["peak_used"] = used
            return got

    def release(self, seq_id: int) -> int:
        """Return all of ``seq_id``'s pages to the free list."""
        with self._lock:
            pages = self._owned.pop(seq_id, [])
            self._free.extend(pages)
            self.stats["releases"] += len(pages)
            return len(pages)

    def release_tail(self, seq_id: int, n_tokens: int) -> int:
        """Truncate ``seq_id``'s page list to what ``n_tokens`` tokens need
        (``ceil(n_tokens / page_size)`` pages) and return the tail pages to
        the free list: the rejected-draft rollback of speculative decode.
        Page-granular: a partly used last page is kept, and its stale slots
        past the tail are never read (the kernels mask by position).
        Raises ``KeyError`` for a sequence the pool does not own (e.g. a
        double release) and ``ValueError`` for a negative count. Returns
        the number of pages freed."""
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        with self._lock:
            if seq_id not in self._owned:
                raise KeyError(f"pool does not own sequence {seq_id}")
            owned = self._owned[seq_id]
            keep = -(-n_tokens // self.page_size)
            if keep >= len(owned):
                return 0
            tail = owned[keep:]
            del owned[keep:]
            self._free.extend(tail)
            self.stats["releases"] += len(tail)
            return len(tail)

    def pages_of(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._owned.get(seq_id, ()))

    def fill_block_row(self, seq_id: int, out: np.ndarray):
        """Write ``seq_id``'s block table into ``out`` (max_seq_pages,)
        in place — unused tail stays 0 (in bounds, masked by seq_len)."""
        with self._lock:
            pages = self._owned.get(seq_id, ())
            out[:len(pages)] = pages
            out[len(pages):] = 0

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats, num_pages=self.num_pages,
                        page_size=self.page_size, free_pages=len(self._free),
                        used_pages=self.num_pages - len(self._free))
