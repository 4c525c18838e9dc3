"""Runtime protocol: ``backend="nel"|"compiled"`` selects an object
(counterpart of ``repro.runtime.backends``).

  * ``CompiledRuntime`` — the fused stacked-axis path: an algorithm's
    ``_fused_infer`` runs over the store's stacked state (checkout ->
    epochs -> commit); prediction is one forward over all particles,
    averaged over the live slots. Every ported algorithm has a fused
    form, so there is no fallback to the actor path. ``program`` and
    ``run`` dispatch a ``ProgramSpec`` through the ProgramCache under the
    PD's store generation: the train steps, the SWAG collection and
    ``predict`` (a CUDA graph each on the card, eager on the CPU).
  * ``NelRuntime`` — the reference's default, the paper-faithful actor
    path. Actor messaging is not ported yet (ROADMAP.md, module queue:
    the actor runtime), so its ``infer`` and ``predict`` raise; pass
    ``backend="compiled"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.tree import to_device
from . import specs
from .cache import ProgramCache, global_cache
from .program import Program, ProgramSpec

BACKENDS = ("nel", "compiled")


class NelRuntime:
    name = "nel"

    def __init__(self, pd, cache: Optional[ProgramCache] = None):
        self.pd = pd
        self.cache = cache if cache is not None else global_cache()

    @staticmethod
    def _missing():
        return NotImplementedError(
            "the actor-messaging (NEL) backend is not ported yet (ROADMAP.md, "
            "module queue: the actor runtime); pass backend=\"compiled\"")

    def infer(self, algo, dataloader, epochs: int, **kw):
        raise self._missing()

    def predict(self, pd, batch):
        raise self._missing()


class CompiledRuntime(NelRuntime):
    name = "compiled"

    def program(self, spec: ProgramSpec, *args,
                state_token=None) -> Program:
        """The cached program for ``spec`` at these arguments, keyed on the
        PD's store generation unless ``state_token`` says otherwise."""
        if state_token is None:
            state_token = self.pd.store.generation()
        return self.cache.program(spec, args, state_token)

    def run(self, spec: ProgramSpec, *args, state_token=None):
        """Lookup (capturing on a miss) and run one program."""
        return self.program(spec, *args, state_token=state_token)(*args)

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name,
                "store": dict(self.pd.store.stats),
                "program_cache": self.cache.snapshot_stats()}

    def infer(self, algo, dataloader, epochs: int, **kw):
        return algo._fused_infer(dataloader, epochs, **kw)

    def predict(self, pd, batch):
        if not pd.particle_ids():
            raise ValueError("the PushDistribution holds no particles")
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
