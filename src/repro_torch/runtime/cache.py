"""ProgramCache: the cache of captured steps (counterpart of
``repro.runtime.cache``).

Cache-key anatomy (DESIGN.md §8; the reference's ``Placement`` enters
through the arguments: a program over ``Sharded`` ones is one program
per position, each keyed with the plan's ``plan_key()`` and its position
in the state token, ``program.ShardedProgram``):

    (spec.key,            # semantic identity of the step
     in/out kinds,        # argument roles
     spec.precision,      # mixed-precision policy token
     device,              # where the arguments live
     state_token,         # store generation: particle-set changes miss
     arg keys)            # per argument (structure, shape, dtype), plus the
                          # leaves' addresses for the in-place kinds, so a
                          # replaced tree misses (program.arg_key)

``stats`` keeps the reference's names: ``hits`` (key present), ``misses``
(key absent), ``cold_compiles`` (a step was captured: here every miss),
``evictions`` (LRU). A program also goes, outside the stats, once a
tensor of an in-place argument it was captured on is freed (a pool
replaced by a new service, params replaced by a commit): its key can
only be hit again through a new tensor at the same address, and its
graph's private memory pool would stay resident for nothing.
``ProgramCache(capturer=...)`` takes the capture strategy:
``program.lower`` by default (a CUDA graph on the card, the eager body on
the CPU), ``program.eager`` for an eager pass on the card, or a test's
stub; a capturer is ``capturer(spec, args, cache_key) -> Program``.

``program_costs()`` gives each entry's cost attribution (the reference's
keys: name, a 16-hex fingerprint of its key, particle count, param bytes
per device, the ``Program.cost()`` dict) beside what only a captured
program has (``graph``, ``capture_s``, ``pool_bytes``). Spans (DESIGN.md
§12, cat ``runtime``): the ``cache.hit`` and ``cache.miss`` instants of a
lookup and a ``runtime.lower`` span around a capture.
"""
from __future__ import annotations

import hashlib
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.store import Sharded
from ..core.tree import tree_leaves
from ..obs import trace as _trace
from .program import (IN_PLACE, Program, ProgramSpec, ShardedProgram,
                      arg_device, arg_key, lower)


def _key_fingerprint(key: Tuple) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


class ProgramCache:
    """Process-wide (or private) spec -> Program cache.

    Bounded LRU: ``max_programs`` caps resident programs; an evicted
    program that is still referenced keeps working, and a re-lookup
    captures it anew. ``released`` counts the programs dropped because a
    tensor they were captured on was freed (module doc)."""

    def __init__(self, max_programs: int = 512,
                 capturer: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._programs: "OrderedDict[Tuple, Program]" = OrderedDict()
        self.max_programs = max_programs
        self.capturer = capturer if capturer is not None else lower
        self.stats = {"hits": 0, "misses": 0, "cold_compiles": 0,
                      "evictions": 0}
        self.released = 0
        # key -> weakrefs to the program's in-place leaves; a callback
        # queues (key, program) on _dead, which the next call under the
        # lock drops (a callback may fire inside a locked section)
        self._watch: Dict[Tuple, List] = {}
        self._dead: List[Tuple[Tuple, Program]] = []
        # programs over sharded arguments: one per (spec, plan, layout),
        # holding a cached Program per position (program.ShardedProgram)
        self._sharded: "OrderedDict[Tuple, ShardedProgram]" = OrderedDict()

    # -- key construction ----------------------------------------------------
    @staticmethod
    def cache_key(spec: ProgramSpec, args, state_token=None,
                  arg_keys: Optional[Sequence] = None) -> Tuple:
        keys = tuple(
            arg_keys[i] if arg_keys is not None and arg_keys[i] is not None
            else arg_key(kind, a)
            for i, (kind, a) in enumerate(zip(spec.in_kinds, args)))
        return (spec.key, spec.in_kinds, spec.out_kinds, spec.precision,
                str(arg_device(args)), state_token, keys)

    # -- the lookup path -----------------------------------------------------
    def lookup(self, spec: ProgramSpec, args, state_token=None,
               arg_keys: Optional[Sequence] = None) -> Tuple[Program, bool]:
        """(program, hit). On a miss the capturer builds the program (a
        cold compile). ``arg_keys`` lets hot paths pass precomputed
        ``program.arg_key`` entries (None entries are computed here):
        engines keep the params' key between store commits and the page
        pool's between generations, so a step never walks those trees."""
        if any(isinstance(a, Sharded) for a in args):
            return self._lookup_sharded(spec, args, state_token, arg_keys)
        key = self.cache_key(spec, args, state_token, arg_keys)
        with self._lock:
            self._release_dead()
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self.stats["hits"] += 1
                _trace.instant("cache.hit", "runtime", program=spec.name)
                return prog, True
            self.stats["misses"] += 1
            _trace.instant("cache.miss", "runtime", program=spec.name)
        with _trace.span("runtime.lower", "runtime", program=spec.name):
            built = self.capturer(spec, args, key)
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = built
                self._programs[key] = built
                self._watch[key] = self._watchers(key, built, spec, args)
                while len(self._programs) > self.max_programs:
                    old, _ = self._programs.popitem(last=False)
                    self._watch.pop(old, None)
                    self.stats["evictions"] += 1
                self.stats["cold_compiles"] += 1
        return prog, False

    def _lookup_sharded(self, spec, args, state_token, arg_keys):
        """(ShardedProgram, hit) for arguments split over a mesh: the
        per-position programs are entries of this cache (captured, and
        counted in ``stats``, once per position), keyed on the plan and
        the position; the wrapper is found again by the plan, the
        per-shard keys of the sharded arguments and the abstract keys of
        the others, and goes once a tensor of a shard is freed."""
        keys = tuple(
            arg_keys[i] if arg_keys is not None and arg_keys[i] is not None
            else arg_key(kind, a) if isinstance(a, Sharded)
            else arg_key(kind if kind not in IN_PLACE else "replicated", a)
            for i, (kind, a) in enumerate(zip(spec.in_kinds, args)))
        key = ("sharded", spec.key, spec.in_kinds, spec.out_kinds,
               spec.precision, state_token, keys)
        with self._lock:
            self._release_dead()
            sp = self._sharded.get(key)
            if sp is not None:
                self._sharded.move_to_end(key)
                self.stats["hits"] += 1
                _trace.instant("cache.hit", "runtime", program=spec.name)
                return sp, True
        sp = ShardedProgram(self, spec, args, state_token, keys)
        with self._lock:
            self._sharded[key] = sp
            dead = self._dead

            def freed(_ref, key=key, sp=sp):
                dead.append((("sharded", key), sp))

            self._watch[("sharded", key)] = [
                weakref.ref(x, freed) for a in args
                if isinstance(a, Sharded) for x in a.leaves()]
            while len(self._sharded) > self.max_programs:
                old, _ = self._sharded.popitem(last=False)
                self._watch.pop(("sharded", old), None)
        return sp, False

    def _watchers(self, key, prog, spec, args) -> List:
        dead = self._dead

        def freed(_ref):
            dead.append((key, prog))

        return [weakref.ref(x, freed)
                for kind, a in zip(spec.in_kinds, args) if kind in IN_PLACE
                for x in tree_leaves(a)]

    def _release_dead(self):
        """Drop the programs whose in-place tensors were freed (lock
        held); a key captured anew since then keeps its new program."""
        while self._dead:
            key, prog = self._dead.pop()
            if key[0] == "sharded":
                if self._sharded.get(key[1]) is prog:
                    del self._sharded[key[1]]
                    del self._watch[key]
                continue
            if self._programs.get(key) is prog:
                del self._programs[key]
                del self._watch[key]
                self.released += 1

    def program(self, spec: ProgramSpec, args, state_token=None,
                arg_keys: Optional[Sequence] = None) -> Program:
        return self.lookup(spec, args, state_token, arg_keys)[0]

    def run(self, spec: ProgramSpec, *args, state_token=None):
        """Lookup (capturing on a miss), then run, in one call."""
        return self.program(spec, args, state_token)(*args)

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            self._release_dead()
            return len(self._programs)

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._lock:
            self._release_dead()
            s = dict(self.stats)
            s["programs"] = len(self._programs)
            total = s["hits"] + s["misses"]
            s["hit_rate"] = s["hits"] / total if total else 0.0
            return s

    def program_costs(self, compute: bool = False) -> List[Dict[str, Any]]:
        """Per entry, least recently used first: name, key fingerprint,
        particle count, param bytes per device and ``cost``: the
        ``Program.cost()`` dict once it has been asked for, or with
        ``compute=True`` for every program that has run (None before a
        program's first run, which is where its cost is counted); then
        whether it is a captured graph, the seconds its capture took and
        the bytes its graph's private pool reserved."""
        with self._lock:
            self._release_dead()
            items = list(self._programs.items())
        return [{"name": p.name, "fingerprint": _key_fingerprint(key),
                 "num_particles": p.num_particles,
                 "param_bytes_per_device": p.param_bytes_per_device,
                 "cost": p.cost() if compute else p.cost_if_computed(),
                 "graph": p.graph is not None, "capture_s": p.capture_s,
                 "pool_bytes": p.pool_bytes}
                for key, p in items]

    def clear(self):
        with self._lock:
            self._programs.clear()
            self._sharded.clear()
            self._watch.clear()
            self._dead.clear()


_GLOBAL = ProgramCache()


def global_cache() -> ProgramCache:
    return _GLOBAL
