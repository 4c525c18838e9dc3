"""Hand-rolled optimizers (counterpart of ``repro.optim.optimizers``:
``sgd``, ``adam``, ``adafactor`` and ``make``; not ``torch.optim``, whose
Adam differs in detail).

Interface: ``opt.init(params) -> state``; ``opt.update(params, grads,
state) -> (new_params, new_state)``, functional over tensor trees. One
particle's state carries a 0-d int32 ``step``; on the store's stacked
trees ``step`` is ``(P,)`` — what ``jax.vmap(optimizer.update)`` sees in
the reference — and broadcasts against each ``(P, ...)`` leaf, so one
update serves one particle or a whole stacked ensemble. ``lr`` is a
number or a schedule of the step (``optim.schedules``), read per row.
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


def adafactor(lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern): O(rows + cols) state for
    matrices.

    The reference applies it to one particle under ``vmap``; here a
    stacked update sees ``(P, ...)`` leaves and a ``(P,)`` step, so every
    rule is taken per particle: a leaf is a matrix when its per-particle
    shape has two or more axes (a unit-stacked ``(n_units, d_in, d_out)``
    weight is factored over its last two, with one RMS across its
    units), ``vr`` drops the last axis and ``vc`` the second-to-last,
    ``beta = 1 - step^-decay`` is one value a row, and the clipping RMS
    runs over all of one particle's axes. The state is the reference's,
    in fp32: ``{"step", "v": tree of {"vr", "vc"} | {"v"}}``."""
    lr_fn = _sched(lr)

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"step": _step0(params), "v": tree_map(one, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        lead = step.dim()                   # 1 on stacked trees: axis P
        beta = 1.0 - step.float() ** (-decay)

        def one(p, g, v):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if p.dim() - lead >= 2:
                b = _rows(beta, v["vr"])
                vr = b * v["vr"] + (1 - b) * g2.mean(-1)
                vc = b * v["vc"] + (1 - b) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    vr.mean(-1, keepdim=True)[..., None], min=eps)
                u = g32 / torch.sqrt(denom + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                b = _rows(beta, g2)
                nv = {"v": b * v["v"] + (1 - b) * g2}
                u = g32 / torch.sqrt(nv["v"] + eps)
            sq = torch.square(u)
            ms = sq.reshape(sq.shape[0], -1).mean(-1) if lead else sq.mean()
            rms = torch.sqrt(ms + 1e-12)
            u = u / _rows(torch.clamp(rms / clip_threshold, min=1.0), u)
            return p - _rows(lr_t, p) * u.to(p.dtype), nv

        # walked along the params: at each param leaf the state's
        # {"vr", "vc"} | {"v"} dict, and then each leaf's (p, v) pair
        out = tree_map(one, params, grads, state["v"])
        return (tree_map(lambda _, o: o[0], params, out),
                {"step": step, "v": tree_map(lambda _, o: o[1], params, out)})

    return Optimizer(init, update, "adafactor")


def make(name, lr=1e-3, **kw) -> Optimizer:
    """The optimizer ``name`` ("sgd" | "adam" | "adafactor") names, or a
    model config names in its ``optimizer`` field (what the reference's
    launch steps pass: ``make_optimizer(cfg.optimizer, lr)``)."""
    name = getattr(name, "optimizer", name)
    return {"sgd": sgd, "adam": adam, "adafactor": adafactor}[name](lr, **kw)
