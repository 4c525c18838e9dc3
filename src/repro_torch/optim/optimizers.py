"""Hand-rolled optimizers (counterpart of ``repro.optim.optimizers``:
``sgd`` and ``adam``; not ``torch.optim``, whose Adam differs in detail).

Interface: ``opt.init(params) -> state``; ``opt.update(params, grads,
state) -> (new_params, new_state)``, functional over tensor trees. One
particle's state carries a 0-d int32 ``step``; on the store's stacked
trees ``step`` is ``(P,)`` — what ``jax.vmap(optimizer.update)`` sees in
the reference — and broadcasts against each ``(P, ...)`` leaf, so one
update serves one particle or a whole stacked ensemble.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..core.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str = "opt"


def _sched(lr):
    return lr if callable(lr) else (lambda step: lr)


def _rows(v, x):
    """Per-row value ``v`` (a number, or a tensor of shape () or (P,))
    broadcast against leaf x."""
    if not isinstance(v, torch.Tensor):
        return v
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr=1e-2, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            upd = mu
        else:
            mu = None
            upd = grads
        new = tree_map(lambda p, u: p - _rows(lr_t, p) * u.to(p.dtype),
                       params, upd)
        return new, {"step": step, "mu": mu}

    return Optimizer(init, update, "sgd")


def adam(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return {"step": _step0(params),
                "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], grads)
        # the reference's arithmetic: b ** step in fp32, eps outside the sqrt
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(p, m_, v_):
            u = (m_ / _rows(c1, m_)) / (torch.sqrt(v_ / _rows(c2, v_)) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return p - _rows(lr_t, p) * u.to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adam")
