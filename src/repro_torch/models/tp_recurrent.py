"""Mamba2 and RWKV6 over a model group (the model axis of a 2D placement;
``models.tp`` runs the rest of the stack).

A position computes its heads: the scan of each head runs at exactly one
position, and whatever spans every head (a norm over all channels, a
row-parallel product) is summed over the group in position order
(``tp.reduce_sum``), so every position holds the same bits.

RWKV6 (``models.rwkv``). The rules split ``time_mix/{wr,wk,wv,wg}`` by
columns and ``time_mix/wo`` by rows: a column block is whole heads. The
token shift and the DDLerp mixes read the replicated residual and run
whole at every position; the decay (``w0``, ``lora_w``) and the bonus
``u`` are replicated, and a position takes its heads' channels of them.
``ln_x`` normalizes over all of D: its mean and then its variance come
from the group's sums of each position's partial sums. ``wo`` gives
partials. In the channel-mix ``wk`` is split by columns and ``wv`` by
rows, ``wr`` is replicated: the sigmoid gate multiplies the summed
``wv`` output. The state's ``state`` holds the position's heads; the
token-shift rows ``x_last_tm`` / ``x_last_cm`` are replicated.

Mamba2 (``models.mamba``). The rules split ``in_proj/w`` by contiguous
columns of [z | x | B | C | dt], which cut across those boundaries: each
position computes its column block of the projection and the group
all-gathers it (``tp.all_gather``); a position then takes its heads' z,
x and dt, and all of B and C, which every head shares. The conv runs on
its x channels and on B and C (its slice of the replicated ``conv_w`` /
``conv_b``), the SSD scan on its H / m heads (``A_log``, ``dt_bias`` and
``D`` sliced). The gated RMSNorm ``gn`` spans d_inner: its mean square
is the group's sum of partial sums of squares. ``out_proj`` is
replicated: a position multiplies by its heads' rows, and the partials
are summed. The state's ``ssm`` holds the position's heads, its
``conv`` the position's x channels and B and C.

The divisibility drop: where the axis does not divide a block's heads,
or the rules left its weights whole, the block runs whole at every
position (its split leaves joined by an all-gather) and gives a
replicated output; the channel-mix alone does so when the axis leaves
``d_ff`` whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import mamba as mamba_mod
from . import rwkv as rwkv_mod
from . import tp
from .blocks import _per_particle, dense_apply, norm_apply

EPS = 1e-6                          # ``blocks.norm_apply``'s


def _join(trees, names, devices):
    """Per-position trees whose leaves at ``names`` ({key path: dim}) are
    the model shards of one leaf -> per-position trees holding the whole
    leaf (joined in position order)."""
    out = [_copy(t) for t in trees]
    for path, dim in names.items():
        whole = tp.all_gather([_get(t, path) for t in trees], dim, devices)
        for t, w in zip(out, whole):
            _get(t, path[:-1])[path[-1]] = w
    return out


def _copy(t):
    return {k: _copy(v) for k, v in t.items()} if isinstance(t, dict) else t


def _get(t, path):
    for k in path:
        t = t[k]
    return t


def _group_norm_stats(parts, devices, n: int, centred: bool):
    """The statistics a norm over a split channel axis of ``n`` channels
    needs, from each position's part (fp32): the mean and the variance
    (``centred``: the second sum is of the deviations from the summed
    mean, as ``norm_apply`` computes them), or the mean square."""
    if not centred:
        ss = tp.reduce_sum([p.square().sum(-1, keepdim=True) for p in parts],
                           devices)
        return [s / n for s in ss]
    mus = [s / n for s in tp.reduce_sum([p.sum(-1, keepdim=True)
                                         for p in parts], devices)]
    vs = tp.reduce_sum([(p - mu).square().sum(-1, keepdim=True)
                        for p, mu in zip(parts, mus)], devices)
    return list(zip(mus, [v / n for v in vs]))


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------

_RWKV_TM = {("time_mix", n, "w"): -1 for n in ("wr", "wk", "wv", "wg")}
_RWKV_TM[("time_mix", "wo", "w")] = -2
_RWKV_CM = {("channel_mix", "wk", "w"): -1, ("channel_mix", "wv", "w"): -2}


def rwkv_mode(p, cfg, m: int) -> str:
    """"heads" (each position its D / m channels, whole heads), "whole"
    (the rules left the time-mix whole) or "join" (its columns cut a
    head: joined, then whole) for a position's params ``p``."""
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    cols = p["time_mix"]["wr"]["w"].shape[-1]
    if cols == D:
        return "whole"
    return "heads" if (D // hd) % m == 0 else "join"


def _cm_split(cm, cfg) -> bool:
    return cm["wk"]["w"].shape[-1] != cfg.d_ff


def rwkv_state_init(p, cfg, m: int, particles: int, batch: int, *, dtype,
                    device, lead=()):
    """A position's empty state: ``rwkv.rwkv_state_init``'s with its
    heads (every head where the block runs whole)."""
    st = rwkv_mod.rwkv_state_init(cfg, particles, batch, dtype=dtype,
                                  device=device, lead=lead)
    if rwkv_mode(p, cfg, m) == "heads":
        s = st["state"]
        st["state"] = s.new_zeros(s.shape[:-3] + (s.shape[-3] // m,)
                                  + s.shape[-2:])
    return st


def _time_mix(tms, xs, xprevs, cfg, devices, states, step: bool):
    """The split time-mix: (the summed outputs, the new states)."""
    m = len(tms)
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    Hl, Dl = D // hd // m, D // m
    ys, gs, news = [], [], []
    for j, (tm, x, xp) in enumerate(zip(tms, xs, xprevs)):
        r, k, v, g, logw = rwkv_mod._rkvgw(tm, x, xp, Hl, hd,
                                           ch=slice(j * Dl, (j + 1) * Dl))
        u = tm["u"][..., j * Hl:(j + 1) * Hl, :]
        st = None if states is None else states[j]
        if step:
            y, s1 = rwkv_mod.scan_step(r, k, v, logw, u, st)
        else:
            y, s1 = rwkv_mod.scan_chunked(r, k, v, logw, u, st)
        ys.append(y)
        gs.append(g)
        news.append(s1)
    yfs = [y.float() for y in ys]
    parts = []
    for j, (tm, yf, (mu, var), g) in enumerate(zip(
            tms, yfs, _group_norm_stats(yfs, devices, D, True), gs)):
        ln, ch = tm["ln_x"], slice(j * Dl, (j + 1) * Dl)
        yn = (yf - mu) * torch.rsqrt(var + EPS) \
            * _per_particle(ln["scale"][..., ch], yf) \
            + _per_particle(ln["bias"][..., ch], yf)
        parts.append(dense_apply(tm["wo"], yn.to(ys[j].dtype) * g))
    return tp.reduce_sum(parts, devices), news


def _channel_mix(cms, xs, xlasts, cfg, devices):
    """The channel-mix: its ``wk`` columns and ``wv`` rows split (the
    partials summed before the gate), or whole at every position."""
    if not _cm_split(cms[0], cfg):
        return [rwkv_mod.channel_mix(c, x, xl)[0]
                for c, x, xl in zip(cms, xs, xlasts)]
    gates, parts = [], []
    for cm, x, xl in zip(cms, xs, xlasts):
        xx = rwkv_mod._shifted(x, xl) - x
        xk = x + xx * rwkv_mod._mu(cm["mu_k"], x)
        xr = x + xx * rwkv_mod._mu(cm["mu_r"], x)
        kk = torch.square(F.relu(dense_apply(cm["wk"], xk)))
        parts.append(dense_apply(cm["wv"], kk))
        gates.append(torch.sigmoid(dense_apply(cm["wr"], xr)))
    return [g * v for g, v in zip(gates, tp.reduce_sum(parts, devices))]


def rwkv_layer(ps, xs, cfg, devices, sts=None):
    """One RWKV6 block over the group: the chunked scan from a zero state
    (``sts`` None: training and prefill) or one step from each position's
    state ``sts``. Returns (the residuals, each position's new state)."""
    m, step = len(ps), sts is not None
    mode = rwkv_mode(ps[0], cfg, m)
    if mode == "join":
        ps = _join(ps, _RWKV_TM, devices)
    if mode != "heads":
        if _cm_split(ps[0]["channel_mix"], cfg):
            ps = _join(ps, _RWKV_CM, devices)
        return _whole(rwkv_mod.rwkv_block_full, rwkv_mod.rwkv_block_decode,
                      ps, xs, cfg, sts)
    dt = xs[0].dtype
    h1 = [norm_apply(p["ln1"], x) for p, x in zip(ps, xs)]
    prev = ([st["x_last_tm"][:, :, None].to(dt) for st in sts] if step
            else [rwkv_mod._shifted(h, None) for h in h1])
    ys, news = _time_mix([p["time_mix"] for p in ps], h1, prev, cfg,
                         devices, [st["state"] for st in sts] if step
                         else None, step)
    xs = [(x + y).to(dt) for x, y in zip(xs, ys)]
    h2 = [norm_apply(p["ln2"], x) for p, x in zip(ps, xs)]
    ys = _channel_mix([p["channel_mix"] for p in ps], h2,
                      [st["x_last_cm"].to(dt) for st in sts] if step
                      else [None] * m, cfg, devices)
    xs = [(x + y).to(dt) for x, y in zip(xs, ys)]
    return xs, [{"state": s, "x_last_tm": a[:, :, -1],
                 "x_last_cm": b[:, :, -1]}
                for s, a, b in zip(news, h1, h2)]


def _whole(full, decode, ps, xs, cfg, sts):
    """The one-device block at every position (a replicated output)."""
    out = [full(p, x, cfg) if sts is None else decode(p, x, cfg, st)
           for p, x, st in zip(ps, xs, sts or [None] * len(ps))]
    return [o[0] for o in out], [o[1] for o in out]


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------

_MAMBA_IN = {("in_proj", "w"): -1}


def mamba_mode(p, cfg, m: int) -> str:
    """"heads", "whole" or "join" (``rwkv_mode``'s) for a position's
    params ``p``."""
    d_inner, H, hd, ds = mamba_mod._dims(cfg)
    if p["in_proj"]["w"].shape[-1] == 2 * d_inner + 2 * ds + H:
        return "whole"
    return "heads" if H % m == 0 else "join"


def mamba_state_init(p, cfg, m: int, particles: int, batch: int, *, dtype,
                     device, lead=()):
    """A position's empty state: ``mamba.mamba_state_init``'s with its
    heads' ``ssm`` and a ``conv`` of its x channels and B and C (every
    head where the block runs whole)."""
    st = mamba_mod.mamba_state_init(cfg, particles, batch, dtype=dtype,
                                    device=device, lead=lead)
    if mamba_mode(p, cfg, m) != "heads":
        return st
    d_inner, H, hd, ds = mamba_mod._dims(cfg)
    ssm, conv = st["ssm"], st["conv"]
    return {"ssm": ssm.new_zeros(ssm.shape[:-3] + (H // m,)
                                 + ssm.shape[-2:]),
            "conv": conv.new_zeros(conv.shape[:-1]
                                   + (H // m * hd + 2 * ds,))}


def mamba_layer(ps, xs, cfg, devices, sts=None):
    """One Mamba2 block over the group (``rwkv_layer``'s contract)."""
    m, step = len(ps), sts is not None
    mode = mamba_mode(ps[0], cfg, m)
    if mode == "join":
        ps = _join(ps, _MAMBA_IN, devices)
    if mode != "heads":
        return _whole(mamba_mod.mamba_block_full,
                      mamba_mod.mamba_block_decode, ps, xs, cfg, sts)
    d_inner, H, hd, ds = mamba_mod._dims(cfg)
    Hl = H // m
    dl = Hl * hd
    xins = [norm_apply(p["ln"], x) for p, x in zip(ps, xs)]
    projs = tp.all_gather([dense_apply(p["in_proj"], xin)
                           for p, xin in zip(ps, xins)], -1, devices)
    yzs, news = [], []
    for j, (p, x, proj) in enumerate(zip(ps, xs, projs)):
        xc, hs = slice(j * dl, (j + 1) * dl), slice(j * Hl, (j + 1) * Hl)
        off = 2 * d_inner + 2 * ds
        z = proj[..., xc]
        conv_in = torch.cat([proj[..., d_inner:2 * d_inner][..., xc],
                             proj[..., 2 * d_inner:off]], -1)
        dt = proj[..., off + j * Hl:off + (j + 1) * Hl]
        cw = torch.cat([p["conv_w"][..., xc], p["conv_w"][..., d_inner:]], -1)
        cb = torch.cat([p["conv_b"][..., xc], p["conv_b"][..., d_inner:]], -1)
        st = sts[j] if step else None
        conv_out, conv_state = mamba_mod._causal_conv(
            cw, cb, conv_in, st["conv"] if step else None)
        xh, Bm, Cm, dtv, loga = mamba_mod.ssd_split(
            conv_out, dt, p["dt_bias"][..., hs], p["A_log"][..., hs], Hl, hd,
            ds)
        if step:
            y, h = mamba_mod.scan_step(xh, Bm, Cm, dtv, loga, st["ssm"])
        else:
            y, h = mamba_mod.scan_chunked(xh, Bm, Cm, dtv, loga)
        y = y + _per_particle(p["D"][..., hs], y[..., 0])[..., None].to(
            x.dtype) * xh
        y = y.reshape(*y.shape[:3], dl)
        yzs.append(y * F.silu(z))
        news.append({"ssm": h, "conv": conv_state})
    yfs = [y.float() for y in yzs]
    parts = []
    for j, (p, yf, ms) in enumerate(zip(
            ps, yfs, _group_norm_stats(yfs, devices, d_inner, False))):
        xc = slice(j * dl, (j + 1) * dl)
        yn = (yf * torch.rsqrt(ms + EPS)
              * _per_particle(p["gn"]["scale"][..., xc], yf)).to(yzs[j].dtype)
        parts.append(dense_apply({"w": p["out_proj"]["w"][..., xc, :]}, yn))
    outs = tp.reduce_sum(parts, devices)
    if step:
        return [x + o.to(x.dtype) for x, o in zip(xs, outs)], news
    return [x + o for x, o in zip(xs, outs)], news


LAYERS = {"mamba": mamba_layer, "rwkv": rwkv_layer}
STATE_INIT = {"mamba": mamba_state_init, "rwkv": rwkv_state_init}
MODES = {"mamba": mamba_mode, "rwkv": rwkv_mode}
