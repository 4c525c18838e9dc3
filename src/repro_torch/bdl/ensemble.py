"""Deep ensembles (Lakshminarayanan et al., 2017) on particles
(counterpart of ``repro.bdl.ensemble``).

No communication between particles (paper §3.1). Under
``backend="compiled"`` every particle trains in one step over the stacked
particle axis: state checked out of the ParticleStore once, updated every
step, committed back once at the end.
"""
from __future__ import annotations

from ..runtime import specs
from .infer import Infer


class DeepEnsemble(Infer):
    def _fused_infer(self, dataloader, epochs: int, *, optimizer,
                     num_particles: int = 4):
        pids = [self.push_dist.p_create(optimizer)
                for _ in range(num_particles)]
        losses = self._fused_epochs(pids, dataloader, epochs,
                                    optimizer=optimizer)
        return pids, losses

    def _fused_epochs(self, pids, dataloader, epochs: int, *, optimizer):
        """Train existing particles for `epochs` (store checkout -> fused
        steps -> one commit); returns the last step's loss per pid."""
        step = specs.ensemble_step(self.module.loss, optimizer,
                                   precision=self.precision)
        co_pids, mask, slots = self._fused_plan(pids)
        ls = None
        with self._checked_out(co_pids, ("params", "opt_state")) as co:
            for _ in range(epochs):
                for batch in dataloader:
                    co["params"], co["opt_state"], ls = step(
                        co["params"], co["opt_state"], self._batch(batch),
                        mask)
        return self._losses(ls, slots)
