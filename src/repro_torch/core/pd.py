"""Push distribution (paper §3.3): P(nn_Theta) = (1/n) sum_i delta_{nn_theta_i}.

Counterpart of ``repro.core.pd`` for the serving slice: a PD wraps a
``ParticleModule`` and owns the ParticleStore its particles live in.

    with PushDistribution(module, seed=0) as pd:      # on cuda
        pids = [pd.p_create() for _ in range(4)]
        svc = serve_decode(pd, cfg, num_pages=256, page_size=16)

``device=`` sets the store's device (``cuda`` unless the caller asks for
another); everything downstream follows the store. Actor messaging
(``p_launch``, the NEL) waits for a later slice.
"""
from __future__ import annotations

from typing import List

import torch

from .particle import ParticleModule
from .precision import get as resolve_precision
from .store import ParticleStore


class PushDistribution:
    def __init__(self, module: ParticleModule, *, seed: int = 0,
                 capacity: int = 0, precision=None, device=None):
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

    @property
    def device(self) -> torch.device:
        return self.store.device

    def p_create(self, *, params=None) -> int:
        """Create one particle: a fresh init from the PD's generator, or the
        given ``params`` tree (moved to the store's device)."""
        if params is None:
            params = self.module.init(self._gen)
        pid = self._next_pid
        self._next_pid += 1
        self.store.register(pid)
        self.store.write("params", pid, params)
        return pid

    def p_params(self, pid: int):
        return self.store.read("params", pid)

    def particle_ids(self) -> List[int]:
        return sorted(self.store.pids)

    def cleanup(self):
        """Nothing runs in the background in this slice; kept for the
        reference's context-manager protocol."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
