"""Mamba2 (SSD) block over the particle axis (counterpart of
``repro.models.mamba``): the chunked scan for training and prefill, the
stepwise oracle, and the O(1)-state decode step.

Per head h (state: d_state x head_dim):

    a_t = exp(-softplus(dt_t + dt_bias) * exp(A_log))      scalar decay
    h_t = a_t h_{t-1} + dt_t * B_t^T x_t
    y_t = C_t h_t + D * x_t

The decay is one scalar per head and step, so a chunk of L steps is
matmuls over pairwise differences of the inclusive cumulative log decay
``ca`` (every kept difference <= 0: no overflow):

    scores_ts = (C_t . B_s) * exp(ca_t - ca_s) * dt_s      (s <= t)
    y_intra   = scores @ x
    y_inter_t = exp(ca_t) * (C_t h_0)
    h_L       = exp(ca_L) h_0 + sum_s exp(ca_L - ca_s) dt_s B_s^T x_s

The pairs s > t are masked in the exponent, before the ``exp`` (the
reference masks after it: its masked exponents are positive, may reach
``inf``, and ``where`` then hands the backward a NaN); the kept pairs'
values are the reference's. Each chunk step runs under a checkpoint, as
the reference's ``jax.checkpoint`` does. The block also holds Mamba2's
depthwise causal conv (width ``cfg.ssm_conv``) over (x, B, C) and the
gated RMSNorm before ``out_proj``.

Activations are (P, B, S, D); parameter leaves lead with the particle
axis. The scans need no parameter, so they run over (P * B) rows. The
state of a sequence is {"ssm": (P, B, H, ds, hd) fp32, "conv": (P, B,
K-1, d_inner + 2 ds)}: the last K-1 conv inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from ..sharding.policy import maybe_shard
from .blocks import _per_particle, dense_apply, dense_init, norm_apply, \
    norm_init


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state


def mamba_init(gen, cfg, lead=()):
    """One particle's block (``lead`` prepends axes such as n_units)."""
    D = cfg.d_model
    d_inner, H, hd, ds = _dims(cfg)
    conv_dim = d_inner + 2 * ds
    dev, lead = gen.device, tuple(lead)
    return {
        "ln": norm_init(cfg.norm, D, device=dev, lead=lead),
        # in_proj -> [z (d_inner), x (d_inner), B (ds), C (ds), dt (H)]
        "in_proj": dense_init(gen, D, 2 * d_inner + 2 * ds + H, lead=lead),
        "conv_w": torch.randn(lead + (cfg.ssm_conv, conv_dim),
                              generator=gen, device=dev) * 0.2,
        "conv_b": torch.zeros(lead + (conv_dim,), device=dev),
        "A_log": torch.zeros(lead + (H,), device=dev),    # A = -exp(0) = -1
        "dt_bias": torch.full(lead + (H,), -2.0, device=dev),
        "D": torch.ones(lead + (H,), device=dev),
        "gn": norm_init("rms", d_inner, device=dev, lead=lead),
        "out_proj": dense_init(gen, d_inner, D, lead=lead),
    }


def _causal_conv(w, b, x, state=None):
    """Depthwise causal conv. w (P, K, C), b (P, C), x (P, B, S, C);
    state (P, B, K-1, C): the carried-in last inputs (zeros when None).
    Returns (silu(conv + b), the new state: the last K-1 inputs)."""
    K, S = w.shape[1], x.shape[2]
    if state is None:
        state = x.new_zeros(x.shape[:2] + (K - 1, x.shape[3]))
    xp = torch.cat([state, x], dim=2)
    y = sum(xp[:, :, i:i + S] * _per_particle(w[:, i], x).to(x.dtype)
            for i in range(K))
    y = F.silu(y + _per_particle(b, x).to(x.dtype))
    return y, xp[:, :, -(K - 1):]


def _project(p, xin, cfg):
    """xin (P, B, S, D) -> z, the conv input [x, B, C], dt."""
    d_inner, H, hd, ds = _dims(cfg)
    proj = dense_apply(p["in_proj"], xin)
    z = proj[..., :d_inner]
    conv_in = proj[..., d_inner:2 * d_inner + 2 * ds]
    dt = proj[..., 2 * d_inner + 2 * ds:]
    return z, conv_in, dt


def _ssd_inputs(p, conv_out, dt, cfg):
    """The scan's inputs: x by head (P, B, S, H, hd), B and C (P, B, S,
    ds), dt after softplus and the log decay (P, B, S, H), fp32."""
    d_inner, H, hd, ds = _dims(cfg)
    return ssd_split(conv_out, dt, p["dt_bias"], p["A_log"], H, hd, ds)


def ssd_split(conv_out, dt, dt_bias, A_log, H, hd, ds):
    """``_ssd_inputs`` for H heads: conv_out (P, B, S, H * hd + 2 ds) the
    heads' x channels then B and C, dt (P, B, S, H) and the heads'
    ``dt_bias`` / ``A_log`` (P, H) (a model position's slice in
    ``models.tp_recurrent``)."""
    dl = H * hd
    xr = conv_out[..., :dl]
    Bm = conv_out[..., dl:dl + ds]
    Cm = conv_out[..., dl + ds:]
    xh = maybe_shard(xr.reshape(*xr.shape[:3], H, hd), "ssm_heads")
    dtv = F.softplus(dt.float() + _per_particle(dt_bias, dt))
    loga = -dtv * _per_particle(torch.exp(A_log), dt)           # <= 0
    return xh, Bm, Cm, dtv, loga


def _chunk_step(h0, xx, BB, CC, dd, la):
    """One chunk of L steps over N rows: xx (N, L, H, hd), BB / CC (N, L,
    ds), dd / la (N, L, H), h0 (N, H, ds, hd) fp32. Returns (h_L, y (N, L,
    H, hd) fp32)."""
    xx, BB, CC = xx.float(), BB.float(), CC.float()
    L = xx.shape[1]
    ca = torch.cumsum(la, dim=1)                              # (N, L, H)
    tri = torch.ones((L, L), dtype=torch.bool,
                     device=xx.device).tril()[None, :, :, None]
    cbts = torch.einsum("btn,bsn->bts", CC, BB)
    diff = (ca[:, :, None] - ca[:, None, :]).masked_fill(~tri, 0.0)
    scores = cbts[..., None] * torch.exp(diff) * dd[:, None]  # (N, t, s, H)
    scores = torch.where(tri, scores, 0.0)
    y = torch.einsum("btsh,bshp->bthp", scores, xx)
    y = y + torch.einsum("btn,bth,bhnp->bthp", CC, torch.exp(ca), h0)
    caL = ca[:, -1:]
    w = torch.exp(caL - ca) * dd                              # (N, L, H)
    h1 = torch.exp(caL[:, 0])[:, :, None, None] * h0 + torch.einsum(
        "bsn,bsh,bshp->bhnp", BB, w, xx)
    return h1, y


def _rows(t):
    """(P, B, ...) -> (P * B, ...)."""
    return t.reshape(-1, *t.shape[2:])


def scan_chunked(xh, Bm, Cm, dtv, loga, ssm=None, chunk: int = 64):
    """The chunked scan over ``ssd_split``'s outputs from ``ssm`` (P, B, H,
    ds, hd) (zeros when None). Returns (y (P, B, S, H, hd) in xh's dtype,
    the final state). The last chunk is padded with log decay 0, which
    carries the state through unchanged."""
    P, B, S, H, hd = xh.shape
    ds = Bm.shape[-1]
    L = min(chunk, S)
    n = -(-S // L)
    pad = n * L - S
    seq = [_rows(t) for t in (xh, Bm, Cm, dtv, loga)]
    if pad:
        seq = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in seq]
    h = (xh.new_zeros((P * B, H, ds, hd), dtype=torch.float32) if ssm is None
         else _rows(ssm))
    ys = []
    for i in range(n):
        cols = slice(i * L, (i + 1) * L)
        h, y = _ckpt.checkpoint(_chunk_step, h, *(t[:, cols] for t in seq),
                                use_reentrant=False,
                                preserve_rng_state=False)
        ys.append(y.to(xh.dtype))
    y = torch.cat(ys, dim=1)[:, :S].reshape(P, B, S, H, hd)
    return y, h.reshape(P, B, H, ds, hd)


def scan_step(xh, Bm, Cm, dtv, loga, ssm):
    """One recurrent step over ``ssd_split``'s outputs (S = 1) from ``ssm``
    (P, B, H, ds, hd). Returns (y (P, B, 1, H, hd) in xh's dtype, the new
    state)."""
    P, B, _, H, hd = xh.shape
    h, y = _step(_rows(ssm), *(_rows(t)[:, 0]
                               for t in (xh, Bm, Cm, dtv, loga)))
    return (y.reshape(P, B, 1, H, hd).to(xh.dtype),
            h.reshape(P, B, H, Bm.shape[-1], hd))


def mamba_block_full(p, x, cfg, chunk: int = 64, st=None):
    """x (P, B, S, D) -> (x + block(x), state {"ssm", "conv"}): the
    chunked scan from ``st`` (zeros when None)."""
    P, B, S, D = x.shape
    d_inner = _dims(cfg)[0]
    xin = norm_apply(p["ln"], x)
    z, conv_in, dt = _project(p, xin, cfg)
    conv_out, conv_state = _causal_conv(p["conv_w"], p["conv_b"], conv_in,
                                        None if st is None else st["conv"])
    xh, Bm, Cm, dtv, loga = _ssd_inputs(p, conv_out, dt, cfg)
    y, h = scan_chunked(xh, Bm, Cm, dtv, loga,
                        None if st is None else st["ssm"], chunk)
    y = y + _per_particle(p["D"], y[..., 0])[..., None].to(x.dtype) * xh
    y = y.reshape(P, B, S, d_inner)
    y = norm_apply(p["gn"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y)
    return x + out, {"ssm": h, "conv": conv_state}


def mamba_ref(p, x, cfg):
    """The stepwise scan oracle (tests)."""
    P, B, S, D = x.shape
    d_inner, H, hd, ds = _dims(cfg)
    xin = norm_apply(p["ln"], x)
    z, conv_in, dt = _project(p, xin, cfg)
    conv_out, _ = _causal_conv(p["conv_w"], p["conv_b"], conv_in)
    xh, Bm, Cm, dtv, loga = _ssd_inputs(p, conv_out, dt, cfg)
    xx, BB, CC, dd, la = (_rows(t) for t in (xh, Bm, Cm, dtv, loga))
    h = x.new_zeros((P * B, H, ds, hd), dtype=torch.float32)
    ys = []
    for t in range(S):
        h, y = _step(h, xx[:, t], BB[:, t], CC[:, t], dd[:, t], la[:, t])
        ys.append(y)
    y = torch.stack(ys, 1).reshape(P, B, S, H, hd).to(x.dtype)
    y = y + _per_particle(p["D"], y[..., 0])[..., None].to(x.dtype) * xh
    y = y.reshape(P, B, S, d_inner)
    y = norm_apply(p["gn"], y * F.silu(z))
    return x + dense_apply(p["out_proj"], y)


def _step(h, xx, BB, CC, dd, la):
    """One recurrent step over N rows: xx (N, H, hd), BB / CC (N, ds),
    dd / la (N, H), h (N, H, ds, hd). Returns (h, y (N, H, hd))."""
    xx, BB, CC = xx.float(), BB.float(), CC.float()
    h = torch.exp(la)[:, :, None, None] * h + torch.einsum(
        "bn,bh,bhp->bhnp", BB, dd, xx)
    return h, torch.einsum("bn,bhnp->bhp", CC, h)


def mamba_state_init(cfg, particles: int, batch: int, *, dtype, device,
                     lead=()):
    """An empty state: ssm (P, *lead, B, H, ds, hd) fp32 zeros, conv (P,
    *lead, B, K-1, d_inner + 2 ds) zeros."""
    d_inner, H, hd, ds = _dims(cfg)
    first = (particles,) + tuple(lead) + (batch,)
    return {"ssm": torch.zeros(first + (H, ds, hd), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(first + (cfg.ssm_conv - 1, d_inner + 2 * ds),
                                dtype=dtype, device=device)}


def mamba_block_decode(p, x, cfg, st):
    """One recurrent step. x (P, B, 1, D); st {"ssm", "conv"} as
    ``mamba_state_init`` makes it (not written). Returns (x + block(x),
    the new state)."""
    P, B = x.shape[:2]
    d_inner = _dims(cfg)[0]
    xin = norm_apply(p["ln"], x)
    z, conv_in, dt = _project(p, xin, cfg)
    conv_out, conv_state = _causal_conv(p["conv_w"], p["conv_b"], conv_in,
                                        st["conv"])
    xh, Bm, Cm, dtv, loga = _ssd_inputs(p, conv_out, dt, cfg)
    y, h = scan_step(xh, Bm, Cm, dtv, loga, st["ssm"])
    y = y + _per_particle(p["D"], y[..., 0])[..., None].to(x.dtype) * xh
    y = y.reshape(P, B, 1, d_inner)
    y = norm_apply(p["gn"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y)
    return x + out.to(x.dtype), {"ssm": h, "conv": conv_state}
