"""Deep ensembles (Lakshminarayanan et al., 2017) on particles
(counterpart of ``repro.bdl.ensemble``).

No communication between particles (paper §3.1): under the default
``backend="nel"`` each particle trains on its own device timeline, one
``step`` hop per particle per batch. Under ``backend="compiled"`` every
particle trains in one step over the stacked particle axis, a
``ProgramSpec`` (a CUDA graph on the card): state checked out of the
ParticleStore once, updated in place every step, committed back once at
the end.
"""
from __future__ import annotations

from ..runtime import specs
from .infer import Infer, traced_epochs


class DeepEnsemble(Infer):
    def _nel_infer(self, dataloader, epochs: int, *, optimizer,
                   num_particles: int = 4):
        pd = self.push_dist
        pids = [pd.p_create(optimizer) for _ in range(num_particles)]
        losses = []
        for _ in traced_epochs(epochs, "ensemble"):
            for batch in dataloader:
                batch = self._batch(batch)
                futs = [pd.particles[pid].step(batch) for pid in pids]
                losses = [float(f.wait()) for f in futs]
        return pids, losses

    def _fused_infer(self, dataloader, epochs: int, *, optimizer,
                     num_particles: int = 4):
        pids = [self.push_dist.p_create(optimizer)
                for _ in range(num_particles)]
        losses = self._fused_epochs(pids, dataloader, epochs,
                                    optimizer=optimizer)
        return pids, losses

    def _fused_epochs(self, pids, dataloader, epochs: int, *, optimizer):
        """Train existing particles for `epochs` through the step program,
        fetched once per fused run (store checkout -> steps updating the
        state in place -> one commit); returns the last step's loss per
        pid."""
        rt = self._compiled_runtime()
        spec = specs.ensemble_step(self.module.loss, optimizer,
                                   precision=self.precision)
        co_pids, mask, slots = self._fused_plan(pids)
        prog, ls = None, None
        with self._checked_out(co_pids, ("params", "opt_state")) as co:
            for _ in traced_epochs(epochs, "ensemble"):
                for batch in dataloader:
                    batch = self._batch(batch)
                    if prog is None:    # one cache lookup per fused run
                        prog = rt.program(spec, co["params"],
                                          co["opt_state"], batch, mask)
                    co["params"], co["opt_state"], ls = prog(
                        co["params"], co["opt_state"], batch, mask)
        return self._losses(ls, slots)
