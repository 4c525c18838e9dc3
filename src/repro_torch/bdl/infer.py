"""Infer base class (paper App. B; counterpart of ``repro.bdl.infer``):
BDL algorithms extend Infer and express inference over particles.

``placement=`` (a ``Placement``, or ``"auto"`` for
``Placement.auto(model="auto")`` sized against one particle's bytes)
goes to the PD's store: under a mesh the fused loops run one program per
position (``runtime.program.ShardedProgram``).

``bayes_infer`` is the stable entry point; it hands the algorithm to the
PD's runtime object (``runtime.backends``). Subclasses implement
``_nel_infer`` (the paper-faithful message-passing procedure on the
PD's NEL, the default ``backend="nel"``) and may implement
``_fused_infer`` (an epoch loop over the store's stacked state, checked
out once and committed once, each step a program of the runtime's
``ProgramCache`` fetched once per run). The CompiledRuntime takes the
fused form when there is one and falls back to the NEL procedure
otherwise. Both paths share the PD's ParticleStore.

The NEL procedures convert each host batch to tensors on the store's
device once (``_batch``) and hand that one object to every particle's
hop, and they keep the reference's protocol of one host wait per
particle per step (``float(f.wait())``).

Every epoch loop, fused or on the NEL, iterates ``traced_epochs``: with
tracing on, each epoch is a ``bdl.epoch`` span (DESIGN.md §12) inside a
``torch.profiler.record_function("repro.epoch.<algo>")`` marker.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Union

import torch

from ..core import ParticleModule, PushDistribution
from ..core.store import Placement
from ..core.tree import to_device
from ..obs import trace as _trace
from ..runtime.backends import CompiledRuntime


def traced_epochs(epochs: int, algo: str):
    """``range(epochs)``, each epoch's body (the code between yields) in a
    ``bdl.epoch`` span and a profiler marker while tracing is on; a plain
    ``range`` when it is off."""
    if not _trace.enabled():
        yield from range(epochs)
        return
    for e in range(epochs):
        with _trace.span("bdl.epoch", "bdl", algo=algo, epoch=e), \
                torch.profiler.record_function(f"repro.epoch.{algo}"):
            yield e


def _init_shapes(module):
    """One particle's parameter tree as fake tensors (shapes and dtypes, no
    memory), what ``placement="auto"`` sizes the model axis from. A module
    whose init cannot run on fake tensors raises: pass a ``Placement``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    try:
        with FakeTensorMode():
            return module.init(torch.Generator())
    except (RuntimeError, TypeError) as e:
        raise ValueError(
            'placement="auto" sizes the model axis from one particle\'s '
            "init on fake tensors, which this module's init refused: pass "
            "a Placement") from e


class _OnDevice:
    """A data loader seen through ``to_device``: each pass iterates the
    loader anew (a new epoch's batches), each batch moved as it comes."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = device

    def __iter__(self):
        return (to_device(b, self.device) for b in self.loader)


class Infer:
    def __init__(self, module: ParticleModule, *, num_devices: int = 1,
                 cache_size: int = 4, seed: int = 0, backend: str = "nel",
                 capacity: int = 0, precision=None, device=None,
                 placement: Optional[Union[Placement, str]] = None,
                 offload: bool = False, devices=None):
        self.module = module
        self.num_devices = num_devices if devices is None else len(devices)
        if placement == "auto":
            # sized against the master-dtype bytes of one particle, drawn
            # on the meta device (no memory, no generator draw)
            placement = Placement.auto(
                model="auto", precision=precision,
                param_tree=_init_shapes(module))
        self.push_dist = PushDistribution(module, num_devices=num_devices,
                                          cache_size=cache_size, seed=seed,
                                          backend=backend, capacity=capacity,
                                          precision=precision, device=device,
                                          placement=placement,
                                          offload=offload, devices=devices)

    @property
    def placement(self) -> Placement:
        """The store's placement plan (``core.store.Placement``)."""
        return self.push_dist.placement

    @property
    def backend(self) -> str:
        return self.push_dist.backend

    @property
    def precision(self):
        return self.push_dist.precision

    @property
    def store(self):
        return self.push_dist.store

    def _has_fused(self) -> bool:
        return type(self)._fused_infer is not Infer._fused_infer

    @contextmanager
    def _checked_out(self, pids, keys):
        """Checkout/commit protocol shared by every fused epoch loop: yield
        a dict of stacked state (the loop rebinds its entries as it
        trains); whatever was checked out is committed back exactly once,
        even on a mid-loop failure. ``pids`` None: the full live set's
        canonical trees; a pid list: a dense stack of those rows. The NEL
        is drained first: no hop may write the state once it is checked
        out, nor launch while a step is being captured."""
        self.push_dist.drain()
        store = self.push_dist.store
        co = {}
        try:
            for k in keys:
                co[k] = store.checkout(k, pids)
            yield co
        finally:
            for k, v in co.items():
                store.commit(k, v, pids)

    def _fused_plan(self, pids):
        """(checkout pids, active mask, row index per pid) for one fused
        run over ``pids``.

        The full live set (in any order) -> the canonical capacity-padded
        trees (None) plus the store's active mask: their tensors keep
        their addresses under churn, so the run reuses its captured steps.
        Any other subset -> a dense checkout of exactly those rows under
        an all-ones mask; that stack is new each run, so each subset run
        captures its steps once. Loss vectors are indexed with the
        returned rows."""
        store = self.push_dist.store
        pids = list(pids)
        if len(pids) == len(store) and set(pids) == set(store.pids):
            return None, store.active_mask(), [store.slot_of(p)
                                               for p in pids]
        return pids, torch.ones(len(pids), device=store.device), \
            list(range(len(pids)))

    def _compiled_runtime(self):
        """The PD's runtime when it is the compiled one, else a
        CompiledRuntime over the same PD and cache: a caller may drive
        ``_fused_epochs`` on a PD of another backend."""
        rt = self.push_dist.runtime
        return rt if isinstance(rt, CompiledRuntime) \
            else CompiledRuntime(self.push_dist, rt.cache)

    def _batch(self, batch):
        """One host batch -> tensors on the store's device, once a step.
        The loop passes the very object it gets to the program lookup and
        to the call: a capture's warm-up is the first call only when the
        arguments are the same objects, else the first batch would be
        trained twice."""
        return to_device(batch, self.push_dist.device)

    def _on_device(self, dataloader):
        """``dataloader`` with every batch moved to the store's device,
        for a NEL handler that iterates it on a worker."""
        return _OnDevice(dataloader, self.push_dist.device)

    @staticmethod
    def _losses(ls, slots):
        return [] if ls is None else [float(x) for x in ls.cpu()[slots]]

    def bayes_infer(self, dataloader, epochs: int, **kw):
        return self.push_dist.runtime.infer(self, dataloader, epochs, **kw)

    def _nel_infer(self, dataloader, epochs: int, **kw):
        raise NotImplementedError

    def _fused_infer(self, dataloader, epochs: int, **kw):
        raise NotImplementedError   # overriding marks the algorithm fusable

    def posterior_pred(self, batch):
        return self.push_dist.p_predict(batch)

    def posterior_predictive(self, **kw):
        """Hand the trained posterior to the serving layer: a
        PredictiveService doing BMA over this Infer's particles, with
        every keyword (``max_batch``, ``max_wait_ms``, ``max_queue``,
        ``kind``, ``warmup``, ``cache``, ...) passed on to ``serve``.
        MultiSWAG overrides it to sample its Gaussians. Caller owns the
        service."""
        return self.push_dist.serve(**kw)

    def p_parameters(self):
        return [self.push_dist.p_params(pid)
                for pid in self.push_dist.particle_ids()]

    def cleanup(self):
        self.push_dist.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
