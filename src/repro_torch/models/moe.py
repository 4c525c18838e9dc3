"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): a top-k
router and a static-shape sort-gather dispatch into a fixed (E, C) slot
buffer per particle.

Every shape is fixed by the config and the token count, so the layer is
captured as part of a CUDA graph: no ``bincount`` (on CUDA it reads its
maximum back to size the output), no boolean-mask indexing, no
``nonzero``. Its steps, one particle at a time as the reference's vmap
sees them (the particle axis ``P`` leads every tensor):

  1. router: fp32 logits (T, E), softmax, top k by a stable descending
     sort (``lax.top_k`` puts the lower expert first on a tie; the sort
     keeps that order), weights renormalised over the k;
  2. dispatch: the T * k (token, expert) assignments sorted by expert,
     stably; assignment i of expert e takes slot ``e * C + i`` when
     ``i < C`` (C = ``capacity(cfg, T)``) and is dropped otherwise (the
     reference's extra "drop bin" row ``E * C``);
  3. experts: one batched product over the (E, C, D) buffer against the
     (E, D, F) expert weights (plain large products outside any kernel,
     as the reference computes them);
  4. combine: each assignment reads its slot's output back, weighted, and
     a token sums its k assignments.

Routing is per particle: each particle routes its own ``T = B * S``
tokens with its own capacity and sort.

Every gather reads each source row at most once for a kept assignment
(a masked read adds an exact zero), so the backward's scatter-adds never
sum two nonzero values into one address: the backward is deterministic
on the card, where a scatter-add's order is not fixed.

Under a model axis (``models.tp``) a position holds the experts
``[expert0, expert0 + E_local)``: it routes every token with the
replicated router and computes, and combines, only its own experts'
slots, giving a partial output that the group sums.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.policy import maybe_shard
from .blocks import dense_apply, dense_init, mlp_apply, mlp_init

AUX_KEYS = ("lb_loss", "z_loss", "dropped_frac")


def moe_init(gen, cfg, lead=()):
    """One particle's MoE params (``lead`` prepends axes such as the
    stacked n_units): ``router/w`` (D, E), ``wi`` / ``wg`` (E, D, F),
    ``wo`` (E, F, D), and ``shared`` (an MLP of ``shared_d_ff``) when the
    config has shared experts."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def ew(a, b):
        return torch.randn(tuple(lead) + (E, a, b), generator=gen,
                           device=gen.device) / math.sqrt(a)

    p = {"router": dense_init(gen, D, E, lead=lead),
         "wi": ew(D, Fd), "wg": ew(D, Fd), "wo": ew(Fd, D)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, lead=lead, d_ff=cfg.shared_d_ff)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: the capacity
    factor's share, rounded up to a multiple of 128, at least 128."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(128, -(-c // 128) * 128)


def route(p, xt, cfg):
    """The router over one call's tokens, per particle. xt (P, T, D) ->
    a dict: ``logits`` and ``probs`` (P, T, E) fp32; ``top_p`` (P, T, k)
    renormalised; ``top_e`` (P, T, k) int64; ``counts`` (P, E) the
    assignments each expert drew; ``order`` (P, T * k) the stable sort of
    the assignments (flat index ``t * k + j``) by expert; ``pos`` (P,
    T * k) each assignment's place within its expert, in flat order;
    ``C`` the capacity."""
    P, T, _ = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = dense_apply(p["router"], xt.float())               # (P, T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[..., :k], idx[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(P, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    counts = torch.zeros((P, E), dtype=torch.long, device=xt.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    ar = torch.arange(T * k, device=xt.device)
    pos = torch.empty_like(order).scatter_(1, order,
                                           ar - starts.gather(1, se))
    return {"logits": logits, "probs": probs, "top_p": top_p,
            "top_e": top_e, "counts": counts, "starts": starts,
            "order": order, "pos": pos, "C": capacity(cfg, T)}


def aux_values(r, cfg):
    """(lb_loss, z_loss, dropped_frac), each (P,): the Switch load-balance
    loss, the router z-loss and the share of assignments dropped."""
    E, k = cfg.n_experts, cfg.top_k
    T = r["probs"].shape[1]
    frac_tokens = r["counts"].float() / (T * k)
    frac_probs = r["probs"].mean(1)
    lb = E * (frac_tokens * frac_probs).sum(-1)
    z = torch.logsumexp(r["logits"], dim=-1).square().mean(-1)
    dropped = 1.0 - (r["pos"] < r["C"]).float().mean(-1)
    return {"lb_loss": lb, "z_loss": z, "dropped_frac": dropped}


def _expert_products(x, w):
    """(P, E, C, a) @ (P, E, a, b) -> (P, E, C, b): one batched product
    over the experts a particle. A unit's weights are a strided view of
    the stacked (P, n_units, E, a, b) leaf, which a single product over
    the folded (P * E) batch would first copy whole."""
    return torch.stack([torch.bmm(x[i], w[i]) for i in range(x.shape[0])])


def experts_apply(p, xt, r, cfg, expert0: int = 0):
    """The routed experts' output (P, T, D) over the experts the params
    hold, ``[expert0, expert0 + E_local)``: the slot buffer (P, E_local,
    C, D) gathered from the assignments' rows, the SwiGLU experts as
    batched products, and each token's kept assignments among them read
    back, weighted and summed."""
    P, T, D = xt.shape
    k, C = cfg.top_k, r["C"]
    El = p["wi"].shape[-3]
    dt = xt.dtype
    # the assignment rows (flat order t * k + j): one row per assignment,
    # so that each slot's gather reads a row no other slot reads
    xk = xt[:, :, None, :].expand(P, T, k, D).reshape(P, T * k, D)
    c = torch.arange(C, device=xt.device)
    e = slice(expert0, expert0 + El)
    src = r["starts"][:, e, None] + c                     # (P, El, C)
    filled = c < r["counts"][:, e, None]
    a = r["order"].gather(1, src.clamp(max=T * k - 1).reshape(P, El * C))
    buf = xk.gather(1, a[..., None].expand(P, El * C, D))
    buf = torch.where(filled.reshape(P, El * C, 1), buf, 0.0)
    buf = maybe_shard(buf.reshape(P, El, C, D), "moe_buffer")
    h = _expert_products(buf, p["wi"].to(dt))             # (P, El, C, F)
    g = _expert_products(buf, p["wg"].to(dt))
    h = maybe_shard(F.silu(g) * h, "moe_buffer")
    out_e = maybe_shard(_expert_products(h, p["wo"].to(dt)), "moe_buffer")
    # combine: each kept assignment of a local expert reads its slot
    flat_e = r["top_e"].reshape(P, T * k)
    mine = (r["pos"] < C) & (flat_e >= expert0) & (flat_e < expert0 + El)
    local = ((flat_e - expert0) * C + r["pos"]).clamp(0, El * C - 1)
    per = out_e.reshape(P, El * C, D).gather(
        1, local[..., None].expand(P, T * k, D))
    per = torch.where(mine[..., None], per, 0.0)
    per = maybe_shard(per, "moe_tokens").reshape(P, T, k, D)
    return (per * r["top_p"].to(dt)[..., None]).sum(2)


def moe_apply(p, x, cfg, expert0: int = 0):
    """x (P, B, S, D) -> (out (P, B, S, D), aux {lb_loss, z_loss,
    dropped_frac}: each (P,)). The shared experts' MLP, when the params
    hold one, is added to every token."""
    P, B, S, D = x.shape
    xt = x.reshape(P, B * S, D)
    r = route(p, xt, cfg)
    y = experts_apply(p, xt, r, cfg, expert0)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, cfg)
    y = maybe_shard(y, "moe_tokens")
    return y.reshape(P, B, S, D), aux_values(r, cfg)


def moe_ref(p, x, cfg):
    """Dense (no-capacity, no-drop) oracle: every expert over every token,
    weighted by the token's renormalised top-k weight for it."""
    P, B, S, D = x.shape
    xt = x.reshape(P, -1, D)
    r_logits = dense_apply(p["router"], xt.float())
    probs = torch.softmax(r_logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        h = F.silu(torch.bmm(xt, p["wg"][:, e])) * torch.bmm(xt, p["wi"][:, e])
        oe = torch.bmm(h, p["wo"][:, e])
        w = torch.where(top_e == e, top_p, 0.0).sum(-1)
        y = y + oe * w[..., None]
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, cfg)
    return y.reshape(P, B, S, D)
