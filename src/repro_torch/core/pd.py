"""Push distribution (paper §3.3): P(nn_Theta) = (1/n) sum_i delta_{nn_theta_i}.

Counterpart of ``repro.core.pd``: a PD wraps a ``ParticleModule`` and owns
the ParticleStore its particles live in.

    with PushDistribution(module, seed=0, backend="compiled") as pd:
        pids = [pd.p_create(adam(1e-3)) for _ in range(4)]   # on cuda
        svc = serve_decode(pd, cfg, num_pages=256, page_size=16)

``device=`` sets the store's device (``cuda`` unless the caller asks for
another); everything downstream follows the store. ``backend=`` selects
the runtime object once (``runtime.backends``): ``"compiled"`` runs the
fused stacked-axis algorithms and predictions; ``"nel"``, the reference's
default, is the actor-messaging path (``p_launch``, the NEL), which is
not ported yet — its ``infer`` and ``predict`` raise.
"""
from __future__ import annotations

from typing import List

import torch

from ..runtime.backends import make_runtime
from .particle import ParticleModule
from .precision import get as resolve_precision
from .store import ParticleStore


class PushDistribution:
    def __init__(self, module: ParticleModule, *, seed: int = 0,
                 backend: str = "nel", capacity: int = 0, precision=None,
                 device=None):
        self.module = module
        if precision is None:
            precision = getattr(getattr(module, "cfg", None), "precision",
                                None)
        self.precision = resolve_precision(precision)
        self.store = ParticleStore(capacity=capacity,
                                   precision=self.precision, device=device)
        # one generator on the store's device: particle inits draw from it
        # in creation order, so a seed fixes every particle's weights
        self._gen = torch.Generator(device=self.store.device)
        self._gen.manual_seed(seed)
        self._next_pid = 0
        self.runtime = make_runtime(backend, self)

    @property
    def backend(self) -> str:
        return self.runtime.name

    @property
    def device(self) -> torch.device:
        return self.store.device

    def p_create(self, optimizer=None, *, params=None) -> int:
        """Create one particle: a fresh init from the PD's generator, or the
        given ``params`` tree (moved to the store's device). Writes
        ``"params"`` (first: the slot goes live in the mask with it) and
        ``"opt_state"`` (``optimizer.init(params)``, or empty)."""
        if params is None:
            params = self.module.init(self._gen)
        pid = self._next_pid
        self._next_pid += 1
        self.store.register(pid)
        self.store.write("params", pid, params)
        params = self.store.read("params", pid)
        self.store.write("opt_state", pid, None if optimizer is None
                         else optimizer.init(params))
        return pid

    def p_params(self, pid: int):
        return self.store.read("params", pid)

    def particle_ids(self) -> List[int]:
        return sorted(self.store.pids)

    def p_predict(self, batch):
        """hat f(x) = (1/n) sum_i nn_{theta_i}(x) (paper §3.4), through the
        runtime: one forward over the store's stacked params, averaged over
        the live slots."""
        return self.runtime.predict(self, batch)

    def serve(self, **kw):
        """Batched posterior-predictive service over this PD's store
        (``serve.serve``)."""
        from ..serve import serve as _serve
        return _serve(self, **kw)

    def cleanup(self):
        """Nothing runs in the background; kept for the reference's
        context-manager protocol."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
