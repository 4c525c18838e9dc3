"""Runtime protocol: ``backend="nel"|"compiled"`` selects an object
(counterpart of ``repro.runtime.backends``).

  * ``NelRuntime`` (the default) — the paper-faithful actor path: an
    algorithm's ``_nel_infer`` runs its message-passing procedure on the
    PD's NEL (persistent per-device event loops, ``core.executor``);
    prediction is n per-particle forwards on the event loops, averaged
    on the host.
  * ``CompiledRuntime`` — the fused stacked-axis path: an algorithm's
    ``_fused_infer`` runs over the store's stacked state (checkout ->
    epochs -> commit); algorithms without a fused form fall back to the
    NEL procedure. Prediction is one forward over all particles,
    averaged over the live slots.

Both dispatch a ``ProgramSpec`` through the ProgramCache under the PD's
store generation (``program`` / ``run``: the train steps, the SWAG
collection and ``predict``; a CUDA graph each on the card, eager on the
CPU), and both report ``stats()``: the executor's wait-vs-run counters,
the NEL's dispatch counters, the store's, the cache's, the lifecycle's
(capacity, live and free slots, generation, clones, kills, rebalances),
the placement plan's, obs's and, while a DecodeScheduler serves the
store, the decode section (the reference's keys, section by section).

A graph capture on the card runs in global mode, which refuses launches
from other threads: ``program`` drains the PD's NEL before a lookup
(which may capture) unless it is called from a NEL worker itself.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, runtime_checkable

from ..core.messages import current_wait_hook
from ..core.tree import to_device, tree_map
from ..obs import summary as _obs_summary
from . import specs
from .cache import ProgramCache, global_cache
from .program import Program, ProgramSpec

BACKENDS = ("nel", "compiled")


@runtime_checkable
class Runtime(Protocol):
    """What a runtime backend must provide (DESIGN.md §8). The placement
    comes with the arguments: a ``Sharded`` one runs per position."""
    name: str

    def infer(self, algo, dataloader, epochs: int, **kw): ...

    def predict(self, pd, batch): ...

    def run(self, spec: ProgramSpec, *args, state_token=None): ...

    def stats(self) -> Dict[str, Any]: ...


class _BaseRuntime:
    name = "base"

    def __init__(self, pd, cache: Optional[ProgramCache] = None):
        self.pd = pd
        self.cache = cache if cache is not None else global_cache()

    def _quiesce(self):
        """Drain the PD's NEL, unless this is one of its workers."""
        if current_wait_hook() is None:
            self.pd.drain()

    def program(self, spec: ProgramSpec, *args,
                state_token=None) -> Program:
        """The cached program for ``spec`` at these arguments, keyed on the
        PD's store generation unless ``state_token`` says otherwise."""
        self._quiesce()
        if state_token is None:
            state_token = self.pd.store.generation()
        return self.cache.program(spec, args, state_token)

    def run(self, spec: ProgramSpec, *args, state_token=None):
        """Lookup (capturing on a miss) and run one program."""
        return self.program(spec, *args, state_token=state_token)(*args)

    def stats(self) -> Dict[str, Any]:
        store = self.pd.store
        store_stats = store.snapshot_stats()
        pl = store.placement
        out = {"backend": self.name,
               "executor": self.pd.nel.executor.stats(),
               "dispatch": dict(self.pd.nel.stats),
               "store": store_stats,
               "program_cache": self.cache.snapshot_stats(),
               "lifecycle": {**store.lifecycle_stats(), **self.pd.lifecycle},
               # the placement plan and its footprint
               "placement": {
                   "mesh_shape": (None if pl.mesh is None else
                                  {a: int(pl.mesh.shape[a])
                                   for a in pl.mesh.axis_names}),
                   "mode": pl.mode,
                   "particle_axis": pl.particle_axis,
                   "model_axis": pl.model_axis,
                   "model_axis_size": pl.model_axis_size(),
                   "per_device_param_bytes": store.per_device_bytes("params"),
                   "reshards": store_stats["device_puts"]},
               "obs": _obs_summary()}
        # while a DecodeScheduler serves the store (serve imports runtime,
        # so the import waits for the call)
        from ..serve.batcher import decode_stats_for
        decode = decode_stats_for(store)
        if decode is not None:
            out["decode"] = decode
        return out


class NelRuntime(_BaseRuntime):
    name = "nel"

    def infer(self, algo, dataloader, epochs: int, **kw):
        return algo._nel_infer(dataloader, epochs, **kw)

    def predict(self, pd, batch):
        """n per-particle forwards on the event loops + host average."""
        batch = to_device(batch, pd.device)
        futs = [pd.particles[pid].forward(batch)
                for pid in pd.particle_ids()]
        outs = [f.wait() for f in futs]
        return tree_map(lambda *xs: sum(xs) / len(xs), *outs)


class CompiledRuntime(_BaseRuntime):
    name = "compiled"

    def infer(self, algo, dataloader, epochs: int, **kw):
        if algo._has_fused():
            return algo._fused_infer(dataloader, epochs, **kw)
        return algo._nel_infer(dataloader, epochs, **kw)

    def predict(self, pd, batch):
        if not pd.particle_ids():
            raise ValueError("the PushDistribution holds no particles")
        self._quiesce()
        # mask and stacked params from one atomic store snapshot: a mask
        # bit never goes live before its slot's data
        _, mask, stacked = pd.store.snapshot("params")
        return self.run(specs.ensemble_predict(pd.module.forward), stacked,
                        to_device(batch, pd.device), mask)


def make_runtime(backend: str, pd, cache: Optional[ProgramCache] = None):
    if backend == "nel":
        return NelRuntime(pd, cache)
    if backend == "compiled":
        return CompiledRuntime(pd, cache)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
