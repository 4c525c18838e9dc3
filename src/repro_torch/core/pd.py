"""Push distribution (paper §3.3): P(nn_Theta) = (1/n) sum_i delta_{nn_theta_i}.

Counterpart of ``repro.core.pd``: a PD wraps a ``ParticleModule`` and owns
the NEL (``core.nel``) and the ParticleStore its particles live in. The
API follows the paper's Fig. 2:

    with PushDistribution(module, seed=0) as pd:        # on cuda
        pids = [pd.p_create(adam(1e-3), receive={"GATHER": _gather})
                for _ in range(4)]
        pd.p_wait([pd.p_launch(pids[0], "GATHER")], timeout=60)

``device=`` sets the store's device (``cuda`` unless the caller asks for
another); the NEL's workers and everything downstream follow it.
``placement=`` (a ``core.store.Placement`` over a ``launch.mesh.Mesh``)
splits the store's particle axis over the mesh's positions, whose first
device is then the store's; ``num_devices=`` / ``devices=`` give the NEL
its workers, and ``offload=True`` lets it page particles' params out to
host memory (``core.nel``).
``p_clone`` / ``p_kill`` / ``p_rebalance`` churn the particle set; within
the store's capacity they move no stacked tensor, so no captured step is
captured again (``lifecycle`` counts them; ``bdl.lifecycle`` holds the
policies built on them).
``backend=`` selects the runtime object once (``runtime.backends``):
``"nel"`` (the default) runs every message through the actor runtime;
``"compiled"`` runs the algorithms' fused stacked-axis forms and
predictions as captured programs. Both share the store, so state written
by one is visible to the other.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..runtime.backends import BACKENDS, make_runtime
from .messages import PFuture
from .nel import NodeEventLoop
from .particle import Particle, ParticleModule
from .precision import cast_floats
from .precision import get as resolve_precision
from .store import ParticleStore, Placement


class PushDistribution:
    def __init__(self, module: ParticleModule, *,
                 num_devices: Optional[int] = None, cache_size: int = 4,
                 seed: int = 0, offload: bool = False, backend: str = "nel",
                 max_pending: int = 4096, capacity: int = 0, precision=None,
                 device=None, placement: Optional[Placement] = None,
                 devices: Optional[Sequence] = None):
        if backend not in BACKENDS:
            # validate before the NEL exists: a bad backend must not leave
            # an executor behind
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        self.module = module
        # the precision ladder: explicit argument > module config > fp32.
        # It decides the store's master dtype (params are cast once, at
        # creation), the compute dtype of the train steps and the serve
        # copy (core.precision)
        if precision is None:
            precision = getattr(getattr(module, "cfg", None), "precision",
                                None)
        self.precision = resolve_precision(precision)
        family = getattr(getattr(module, "cfg", None), "family", None)
        if family in ("ssm", "hybrid", "audio", "vlm") and \
                self.precision != resolve_precision("fp32"):
            raise NotImplementedError(
                f"the {family} stacks run under fp32 only: the precision "
                f"presets on them wait for ROADMAP.md queue 1, item 21")
        if placement is not None and placement.mesh is not None:
            device = placement.positions()[0]
        self.nel = NodeEventLoop(num_devices=num_devices,
                                 cache_size=cache_size, offload=offload,
                                 max_pending=max_pending, device=device,
                                 devices=devices)
        self.store = ParticleStore(capacity=capacity,
                                   precision=self.precision, device=device,
                                   placement=placement)
        # a NEL that offloads or spans several devices homes its particles'
        # rows itself (core.nel.ensure_resident)
        self.store.keep_row_devices = self.nel.homes_rows
        # one generator on the store's device: particle inits draw from it
        # in creation order, so a seed fixes every particle's weights
        self._gen = torch.Generator(device=self.store.device)
        self._gen.manual_seed(seed)
        self.particles: Dict[int, Particle] = {}
        self.lifecycle = {"clones": 0, "kills": 0, "rebalances": 0}
        self.runtime = make_runtime(backend, self)

    @property
    def backend(self) -> str:
        return self.runtime.name

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def placement(self):
        return self.store.placement

    def p_create(self, optimizer=None, *, device: Optional[int] = None,
                 receive: Optional[Dict[str, Callable]] = None,
                 state: Optional[dict] = None, params=None) -> int:
        """Create one particle: a fresh init from the PD's generator, or the
        given ``params`` tree (moved to the store's device), on NEL device
        ``device`` (round-robin when None), with message handlers
        ``receive``. The params are cast to the policy's master dtype
        first, so the optimizer state follows it. Writes ``"params"``
        first (the slot goes live in the mask with it), then
        ``"opt_state"`` (``optimizer.init(params)``, or None), ``"grads"``
        (None until a step) and the ``state`` keys. The particle's hops
        compute in the policy's compute dtype."""
        if params is None:
            params = self.module.init(self._gen)
        params = cast_floats(params, self.precision.master)
        pid = self.nel.register(None, device=device)
        self.store.register(pid)
        p = Particle(pid, self.nel, self.module, self.store, optimizer,
                     params=params, state=state,
                     compute_dtype=self.precision.compute
                     if self.precision.casts_compute else None)
        for msg, fn in (receive or {}).items():
            p.on(msg, fn)
        self.nel._particles[pid] = p
        self.particles[pid] = p
        return pid

    # -- elastic lifecycle (DESIGN.md §9) ------------------------------------
    def p_clone(self, pid: int, jitter: float = 0.0, *,
                device: Optional[int] = None) -> int:
        """Replicate a live particle into a free slot: params (plus
        ``jitter`` times N(0, 1) from the PD's generator), optimizer
        state, message handlers and every other state key (the paged KV
        pool's row too) are copied. Params go first, so the slot goes live
        in the mask with the key that serving reads. Within capacity each
        key is a copy inside the stacked tensors (``store.clone_slot``):
        no stacked tensor moves, ``generation()`` does not bump, and no
        captured step is captured again. A clone that fails (a key checked
        out by a fused run) raises and leaves no particle behind. Call it
        under a decode scheduler's ``step_lock`` while that serves."""
        src = self.particles[pid]
        new_pid = self.nel.register(None, device=device)
        self.store.register(new_pid)
        try:
            keys = sorted(self.store.keys_for(pid), key=lambda k: k != "params")
            for key in keys:
                self.store.clone_slot(
                    key, pid, new_pid,
                    jitter=jitter if key == "params" else 0.0,
                    generator=self._gen)
        except BaseException:
            self.nel.unregister(new_pid)
            self.store.unregister(new_pid)
            raise
        p = Particle(new_pid, self.nel, self.module, self.store,
                     src.optimizer, write_state=False,
                     compute_dtype=src.compute_dtype)
        p.receive = dict(src.receive)
        self.nel._particles[new_pid] = p
        self.particles[new_pid] = p
        self.lifecycle["clones"] += 1
        return new_pid

    def p_kill(self, pid: int):
        """Retire a particle: its slot goes on the store's free list (the
        mask flips to 0 there; the stale rows stay, masked out) and the NEL
        drops its mailbox, device entry and active-set entry. Within
        capacity this never changes ``generation()``: nothing is captured
        again. KeyError for an unknown or dead pid."""
        self.particles.pop(pid)
        self.nel.unregister(pid)
        self.store.unregister(pid)
        self.lifecycle["kills"] += 1

    def p_rebalance(self) -> Dict[int, Any]:
        """Re-place live particles evenly across the NEL's devices
        (draining first) and flush the store; returns {pid: (old_dev,
        new_dev)} for the particles that moved ({} on one device)."""
        moves = self.nel.rebalance()
        self.store.rebalance()
        self.lifecycle["rebalances"] += 1
        return moves

    def p_launch(self, pid: int, msg: str, *args, **kwargs) -> PFuture:
        p = self.particles[pid]
        if msg not in p.receive:
            raise KeyError(f"particle {pid} has no handler for {msg!r}")
        return self.nel.dispatch(pid, p.receive[msg], p, *args, **kwargs)

    @staticmethod
    def p_wait(futures: Sequence[PFuture],
               timeout: Optional[float] = None) -> List[Any]:
        """Each future's value, in order; ``timeout`` bounds each wait."""
        return [f.wait(timeout) for f in futures]

    def p_params(self, pid: int):
        return self.particles[pid].parameters()

    def particle_ids(self) -> List[int]:
        return self.nel.particle_ids()

    def p_predict(self, batch):
        """hat f(x) = (1/n) sum_i nn_{theta_i}(x) (paper §3.4), through the
        runtime: the CompiledRuntime runs one forward over the store's
        stacked params averaged over the live slots; the NelRuntime runs n
        per-particle forwards on the event loops and averages on the
        host."""
        return self.runtime.predict(self, batch)

    def stats(self) -> Dict[str, Any]:
        """Executor, dispatch, store, program-cache, lifecycle, placement
        and obs counters in one dict, and the decode section while a
        DecodeScheduler serves the store (``runtime.stats()``)."""
        return self.runtime.stats()

    def obs(self):
        """Observability handle (``repro_torch.obs.Obs``): a snapshot of
        stats, device gauges and per-program costs, the Chrome/Perfetto
        trace dump and Prometheus text::

            trace.enable(); ...; pd.obs().dump_trace("trace.json")
        """
        from ..obs import Obs
        return Obs(self)

    def serve(self, **kw):
        """Batched posterior-predictive service over this PD's store
        (``serve.serve``)."""
        from ..serve import serve as _serve
        return _serve(self, **kw)

    def drain(self, timeout: Optional[float] = None):
        self.nel.drain(timeout)

    def cleanup(self):
        """Finish the NEL's in-flight messages and stop its workers."""
        self.nel.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
