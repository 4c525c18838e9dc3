"""The particle abstraction (paper §3.2; counterpart of
``repro.core.particle``).

A particle wraps a NN with (1) local state — parameters, optimizer state,
user state — held in the PushDistribution's ParticleStore, (2) its own
logical thread of execution (dispatches run on its device's NEL worker),
and (3) message passing: a receive dictionary mapping messages to
locally-defined functions, plus send/get primitives returning PFutures.

The paper's Fig. 1 ``_gather`` runs on this API:

    futures  = {pid: particle.get(pid) for pid in other_particles}
    views    = {pid: fut.wait() for pid, fut in futures.items()}
    views[other].view()
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .functional import ensemble_value_and_grad
from .messages import ParticleView, PFuture, snapshot
from .store import ParticleStore, StoreState
from .tree import tree_map, tree_to


def _on_receiver(fn, device):
    """A handler whose tensor arguments cross to ``device`` (the
    receiver's) when it runs: the message boundary between two devices."""
    def handler(target, *args, **kwargs):
        return fn(target, *tree_to(args, device), **tree_to(kwargs, device))
    return handler


def _one_row(tree):
    """One particle's tree as a one-row stacked view (no copy)."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


class ParticleModule:
    """Bundle of functions defining the NN a particle wraps.

    ``init(generator) -> params`` draws one particle's parameter tree on
    ``generator.device``. ``loss(stacked_params, batch) -> (losses (P,),
    metrics)`` and ``forward(stacked_params, batch) -> outputs (P, ...)``
    take the store's stacked tree with its leading particle axis (the
    reference's take one particle and are vmapped). ``cfg`` is the model
    config serving reads.

    The NEL's per-particle hops call ``_value_and_grad``, ``_forward``
    and ``_loss_value`` on one particle's tree: each runs the stacked
    function on a one-row view and drops the particle axis again."""

    def __init__(self, init: Callable, loss: Optional[Callable] = None,
                 forward: Optional[Callable] = None, cfg: Any = None):
        self.init = init
        self.loss = loss
        self.forward = forward
        self.cfg = cfg
        self._vags: Dict[Any, Callable] = {}

    def _value_and_grad(self, params, batch, compute_dtype=None):
        """(0-d loss, grads) of one particle (the fused path's
        ``ensemble_value_and_grad`` over one row); ``compute_dtype`` is
        the master/compute split of the fused step: the loss and grads
        are computed on a cast of the params and the batch's floats, the
        grads come back in the params' dtype and the loss in fp32."""
        vag = self._vags.get(compute_dtype)
        if vag is None:
            vag = self._vags[compute_dtype] = ensemble_value_and_grad(
                self.loss, compute_dtype)
        losses, grads = vag(_one_row(params), batch)
        return losses[0], tree_map(lambda g: g[0], grads)

    def _forward(self, params, batch):
        with torch.no_grad():
            return tree_map(lambda o: o[0],
                            self.forward(_one_row(params), batch))

    def _loss_value(self, params, batch):
        """One particle's scalar loss, no grads."""
        with torch.no_grad():
            return self.loss(_one_row(params), batch)[0][0]


class Particle:
    """One particle: ``state`` is its mapping view of the PD's store
    (``StoreState``); ``receive`` maps message names to handlers
    ``fn(particle, *args)``.

    A new particle writes ``"params"`` first (its slot goes live in the
    store's mask with that key), then ``"opt_state"``
    (``optimizer.init(params)``, or None), ``"grads"`` (None until a step)
    and the ``state`` keys. ``write_state=False`` attaches to state
    already in the store (``p_clone``'s slot copy). ``compute_dtype``
    (None: the params' own) is the dtype its ``step`` and ``grad`` hops
    compute in."""

    def __init__(self, pid: int, nel, module: ParticleModule,
                 store: ParticleStore, optimizer=None, params=None,
                 state: Optional[dict] = None, write_state: bool = True,
                 compute_dtype=None):
        self.pid = pid
        self.nel = nel
        self.module = module
        self.optimizer = optimizer
        self.compute_dtype = compute_dtype
        self.store = store
        self.state: StoreState = StoreState(store, pid)
        self.receive: Dict[str, Callable] = {}
        if write_state:
            self.state["params"] = params
            self.state["opt_state"] = (
                None if optimizer is None
                else optimizer.init(self.state["params"]))
            self.state["grads"] = None
            for k, v in (state or {}).items():
                self.state[k] = v

    # -- local state access ------------------------------------------------
    def parameters(self):
        return self.state["params"]

    def gradients(self):
        return self.state["grads"]

    # -- registry ------------------------------------------------------------
    def particle_ids(self) -> List[int]:
        return self.nel.particle_ids()

    def on(self, msg: str, fn: Callable):
        self.receive[msg] = fn

    # -- messaging (actor + async-await) ------------------------------------
    def send(self, pid: int, msg: str, *args, **kwargs) -> PFuture:
        """Trigger `msg`'s handler on particle `pid` (its own timeline)."""
        target = self.nel.particle(pid)
        if msg not in target.receive:
            raise KeyError(f"particle {pid} has no handler for {msg!r}")
        fn = target.receive[msg]
        if self.nel._device_of[pid] != self.nel._device_of[self.pid]:
            self.nel._bump("xdev_transfers")
            fn = _on_receiver(fn, self.nel.device_of(pid))
        return self.nel.dispatch(pid, fn, target, *args, **kwargs)

    def get(self, pid: int) -> PFuture:
        """Asynchronously snapshot particle `pid`'s parameters and grads
        (read-only clones, taken on the shared pool)."""
        target = self.nel.particle(pid)
        if self.nel._device_of[pid] != self.nel._device_of[self.pid]:
            self.nel._bump("xdev_transfers")
        here = self.nel.device_of(self.pid)

        def grab(_t):
            # snapshots on the requester's device (a copy only from another
            # device, or from the host where an offloaded row lives)
            grads = _t.state["grads"]
            return ParticleView(
                pid, tree_to(snapshot(_t.state["params"]), here),
                None if grads is None else tree_to(snapshot(grads), here))

        # lock-free read: runs on the shared pool, never queues behind the
        # target device's compute (paper §4.2)
        return self.nel.dispatch(pid, grab, target, lightweight=True)

    # -- local NN computations (dispatched to this particle's device) -------
    def step(self, batch) -> PFuture:
        """Forward+backward+optimizer update on this particle's device."""

        def do(_self):
            loss, grads = _self.module._value_and_grad(
                _self.state["params"], batch, _self.compute_dtype)
            _self.state["grads"] = grads
            if _self.optimizer is not None:
                p, s = _self.optimizer.update(_self.state["params"], grads,
                                              _self.state["opt_state"])
                _self.state["params"], _self.state["opt_state"] = p, s
            return loss

        return self.nel.dispatch(self.pid, do, self, needs_device=True)

    def grad(self, batch) -> PFuture:
        """Backward only: stash grads, do not update params (SVGD phase 1)."""

        def do(_self):
            loss, grads = _self.module._value_and_grad(
                _self.state["params"], batch, _self.compute_dtype)
            _self.state["grads"] = grads
            return loss

        return self.nel.dispatch(self.pid, do, self, needs_device=True)

    def forward(self, batch) -> PFuture:
        def do(_self):
            return _self.module._forward(_self.state["params"], batch)

        return self.nel.dispatch(self.pid, do, self, needs_device=True)

    def apply_update(self, update, lr: float) -> PFuture:
        """theta <- theta - lr * update (SVGD follow; paper Fig. 6)."""

        def do(_self):
            _self.state["params"] = tree_map(
                lambda p, u: p - lr * u.to(p.dtype), _self.state["params"],
                update)

        return self.nel.dispatch(self.pid, do, self, needs_device=True)
