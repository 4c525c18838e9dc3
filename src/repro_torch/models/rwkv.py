"""RWKV6 ("Finch") block over the particle axis (counterpart of
``repro.models.rwkv``): time-mix with a data-dependent decay, and
channel-mix.

The recurrence per head (k-dim x v-dim state S):

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    y_t   = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1) per channel and step.

Training and prefill run a chunked form over chunks of L steps: every
decay ratio is a pairwise difference of the inclusive cumulative log
decay ``a`` (b_t = a_{t-1}, the exclusive one):

    intra: y_t += sum_{s<t} (r_t . (k_s * exp(b_t - a_s))) v_s
                 + (r_t . (k_t * u)) v_t
    inter: y_t += (r_t * exp(b_t)) S_0
    state: S_L  = diag(exp(a_L)) S_0 + sum_s (k_s * exp(a_L - a_s))^T v_s

The pairs s >= t are masked in the exponent, before the ``exp`` (their
exponents are positive: the reference masks after the ``exp``, which
can reach ``inf`` and hand the backward a NaN); the kept pairs' values
are the reference's. Each chunk step runs under a checkpoint, as the
reference's ``jax.checkpoint`` does: one chunk's (N, L, L, H, hd) decay
tensor is rebuilt in the backward instead of kept for every chunk.
Decode is the O(1)-state recurrence.

Activations are (P, B, S, D); parameter leaves lead with the particle
axis. A sequence's state is {"state": (P, B, H, hd, hd) fp32,
"x_last_tm": (P, B, D), "x_last_cm": (P, B, D)}: the time-mix state and
the last token of each half's (normed) input, for the token shift.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from ..sharding.policy import maybe_shard
from .blocks import _per_particle, dense_apply, dense_init, norm_apply, \
    norm_init

LORA_RANK = 32


def _lora_init(gen, d, rank, lead):
    return {"a": torch.randn(lead + (d, rank), generator=gen,
                             device=gen.device) * 0.01,
            "b": torch.randn(lead + (rank, d), generator=gen,
                             device=gen.device) * 0.01}


def _mm(w, x):
    """x (P, ..., d_in) @ w (P, d_in, d_out), in x's dtype."""
    return dense_apply({"w": w}, x)


def _lora(p, x):
    return _mm(p["b"], torch.tanh(_mm(p["a"], x)))


def rwkv_init(gen, cfg, lead=()):
    """One particle's block (``lead`` prepends axes such as n_units)."""
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    dev, lead = gen.device, tuple(lead)
    tm = {
        "mu_x": torch.full(lead + (D,), 0.5, device=dev),
        # per-target DDLerp mixes (r, k, v, g, w)
        **{f"mu_{t}": torch.full(lead + (D,), 0.5, device=dev)
           for t in "rkvgw"},
        **{f"lora_{t}": _lora_init(gen, D, LORA_RANK, lead) for t in "rkvgw"},
        **{k: dense_init(gen, D, D, lead=lead)
           for k in ("wr", "wk", "wv", "wg", "wo")},
        "w0": torch.full(lead + (D,), -2.0, device=dev),  # base log-log decay
        "lora_w": _lora_init(gen, D, 64, lead),
        "u": torch.randn(lead + (H, hd), generator=gen, device=dev) * 0.1,
        "ln_x": norm_init("layer", D, device=dev, lead=lead),
    }
    cm = {
        "mu_k": torch.full(lead + (D,), 0.5, device=dev),
        "mu_r": torch.full(lead + (D,), 0.5, device=dev),
        "wk": dense_init(gen, D, cfg.d_ff, lead=lead),
        "wv": dense_init(gen, cfg.d_ff, D, lead=lead),
        "wr": dense_init(gen, D, D, lead=lead),
    }
    return {"ln1": norm_init(cfg.norm, D, device=dev, lead=lead),
            "time_mix": tm,
            "ln2": norm_init(cfg.norm, D, device=dev, lead=lead),
            "channel_mix": cm}


def _mu(v, x):
    return _per_particle(v, x).to(x.dtype)


def _ddlerp(tm, x, x_prev):
    """Data-dependent token-shift interpolation -> the mixed inputs."""
    xx = x_prev - x
    base = x + xx * _mu(tm["mu_x"], x)
    return {t: x + xx * (_mu(tm[f"mu_{t}"], x) + _lora(tm[f"lora_{t}"],
                                                         base))
            for t in "rkvgw"}


def _rkvgw(tm, x, x_prev, H, hd, ch=None):
    """r, k, v (P, B, S, H, hd), the gate g (P, B, S, H * hd) and the log
    decay (P, B, S, H, hd) fp32, < 0. ``ch`` (a slice of D) names the
    channels of the decay a model position computes (``models.
    tp_recurrent``: its heads'; ``wr|wk|wv|wg`` are then its columns);
    None computes all of them."""
    P, B, S, D = x.shape
    m = _ddlerp(tm, x, x_prev)
    r, k, v = (dense_apply(tm[n], m[t]).reshape(P, B, S, H, hd)
               for n, t in (("wr", "r"), ("wk", "k"), ("wv", "v")))
    g = F.silu(dense_apply(tm["wg"], m["g"]))
    w0, lw = tm["w0"], tm["lora_w"]
    if ch is not None:
        w0, lw = w0[..., ch], {"a": lw["a"], "b": lw["b"][..., ch]}
    logw = -torch.exp(_per_particle(w0, x).float()
                      + _lora(lw, m["w"]).float())
    logw = logw.reshape(P, B, S, H, hd)
    r, k, v = (maybe_shard(t, "ssm_heads") for t in (r, k, v))
    return r, k, v, g, maybe_shard(logw, "ssm_heads")


def _shifted(x, x_last):
    """The token shift: x_prev (P, B, S, D), row 0 from ``x_last`` (P, B,
    D) or zeros."""
    first = torch.zeros_like(x[:, :, :1]) if x_last is None \
        else x_last[:, :, None].to(x.dtype)
    return torch.cat([first, x[:, :, :-1]], dim=2)


def _rows(t):
    """(P, B, ...) -> (P * B, ...)."""
    return t.reshape(-1, *t.shape[2:])


def _chunk_step(S0, rr, kk, vv, ww, u):
    """One chunk of L steps over N rows: rr, kk, vv, ww (N, L, H, hd), u
    (N, H, hd), S0 (N, H, hd, hd) fp32. Returns (S_L, y (N, L, H, hd))."""
    rr, kk, vv = rr.float(), kk.float(), vv.float()
    L = rr.shape[1]
    a = torch.cumsum(ww, dim=1)                     # inclusive cum log decay
    b = a - ww                                      # exclusive
    y_inter = torch.einsum("blhk,bhkv->blhv", rr * torch.exp(b), S0)
    tri = torch.ones((L, L), dtype=torch.bool, device=rr.device).tril(-1)
    keep = tri[None, :, :, None, None]
    diff = (b[:, :, None] - a[:, None, :]).masked_fill(~keep, 0.0)
    scores = (rr[:, :, None] * kk[:, None] * torch.exp(diff)).sum(-1)
    scores = torch.where(tri[None, :, :, None], scores, 0.0)  # (N, t, s, H)
    diag = (rr * kk * u[:, None]).sum(-1)                     # (N, L, H)
    y_intra = torch.einsum("btsh,bshv->bthv", scores, vv) \
        + diag[..., None] * vv
    aL = a[:, -1:]
    S1 = torch.exp(aL[:, 0])[..., None] * S0 + torch.einsum(
        "bshk,bshv->bhkv", kk * torch.exp(aL - a), vv)
    return S1, y_inter + y_intra


def _u_rows(u, B):
    """u (P, H, hd) repeated over the batch: (P * B, H, hd) fp32."""
    u = u.float()
    return u[:, None].expand(u.shape[0], B, *u.shape[1:]).reshape(
        -1, *u.shape[1:])


def scan_chunked(r, k, v, logw, u, state=None, chunk: int = 32):
    """The chunked scan over r, k, v, logw (P, B, S, H, hd) from ``state``
    (P, B, H, hd, hd) (zeros when None) with the bonus u (P, H, hd).
    Returns (y (P, B, S, H * hd) in r's dtype, the final state). The last
    chunk is padded with log decay 0 (w = 1), which carries the state
    through unchanged."""
    P, B, S, H, hd = r.shape
    S0 = (r.new_zeros((P * B, H, hd, hd), dtype=torch.float32)
          if state is None else _rows(state))
    L = min(chunk, S)
    n = -(-S // L)
    pad = n * L - S
    seq = [_rows(t) for t in (r, k, v, logw)]
    if pad:
        seq = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in seq]
    ur = _u_rows(u, B)
    ys = []
    for i in range(n):
        cols = slice(i * L, (i + 1) * L)
        S0, y = _ckpt.checkpoint(_chunk_step, S0, *(t[:, cols] for t in seq),
                                 ur, use_reentrant=False,
                                 preserve_rng_state=False)
        ys.append(y.to(r.dtype))
    y = torch.cat(ys, dim=1)[:, :S].reshape(P, B, S, H * hd)
    return y, S0.reshape(P, B, H, hd, hd)


def scan_step(r, k, v, logw, u, state):
    """One recurrent step over r, k, v, logw (P, B, 1, H, hd) from
    ``state`` (P, B, H, hd, hd). Returns (y (P, B, 1, H * hd) in r's
    dtype, the new state)."""
    P, B, _, H, hd = r.shape
    S1, y = _recur(_rows(state), *(_rows(t)[:, 0] for t in (r, k, v, logw)),
                   _u_rows(u, B))
    return (y.reshape(P, B, 1, H * hd).to(r.dtype),
            S1.reshape(P, B, H, hd, hd))


def time_mix_chunked(tm, x, cfg, state=None, x_last=None, chunk: int = 32):
    """x (P, B, S, D). Returns (out, (state (P, B, H, hd, hd), x_last (P,
    B, D))): ``scan_chunked`` from ``state``."""
    hd = cfg.rwkv_head_dim
    H = x.shape[-1] // hd
    r, k, v, g, logw = _rkvgw(tm, x, _shifted(x, x_last), H, hd)
    y, S1 = scan_chunked(r, k, v, logw, tm["u"], state, chunk)
    y = norm_apply(tm["ln_x"], y) * g
    return dense_apply(tm["wo"], y), (S1, x[:, :, -1])


def _recur(S0, rr, kk, vv, ww, u):
    """One recurrent step over N rows: rr, kk, vv, ww (N, H, hd), u (N,
    H, hd), S0 (N, H, hd, hd). Returns (S_1, y (N, H, hd))."""
    rr, kk, vv = rr.float(), kk.float(), vv.float()
    kv = torch.einsum("bhk,bhv->bhkv", kk, vv)
    y = torch.einsum("bhk,bhkv->bhv", rr, S0 + u[..., None] * kv)
    return torch.exp(ww)[..., None] * S0 + kv, y


def time_mix_ref(tm, x, cfg):
    """The stepwise scan oracle (tests)."""
    P, B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    r, k, v, g, logw = _rkvgw(tm, x, _shifted(x, None), H, hd)
    u = _u_rows(tm["u"], B)
    rr, kk, vv, ww = (_rows(t) for t in (r, k, v, logw))
    S0 = x.new_zeros((P * B, H, hd, hd), dtype=torch.float32)
    ys = []
    for t in range(S):
        S0, y = _recur(S0, rr[:, t], kk[:, t], vv[:, t], ww[:, t], u)
        ys.append(y)
    y = torch.stack(ys, 1).to(x.dtype).reshape(P, B, S, D)
    y = norm_apply(tm["ln_x"], y) * g
    return dense_apply(tm["wo"], y)


def time_mix_decode(tm, x, cfg, state, x_last):
    """x (P, B, 1, D); state (P, B, H, hd, hd). The O(1) recurrent step:
    returns (out, (state, x_last))."""
    hd = cfg.rwkv_head_dim
    H = x.shape[-1] // hd
    r, k, v, g, logw = _rkvgw(tm, x, x_last[:, :, None].to(x.dtype), H, hd)
    y, S1 = scan_step(r, k, v, logw, tm["u"], state)
    y = norm_apply(tm["ln_x"], y) * g
    return dense_apply(tm["wo"], y), (S1, x[:, :, -1])


def channel_mix(cm, x, x_last=None):
    """RWKV channel-mix (squared-relu MLP with the token shift). Returns
    (out, the last token of x)."""
    xx = _shifted(x, x_last) - x
    xk = x + xx * _mu(cm["mu_k"], x)
    xr = x + xx * _mu(cm["mu_r"], x)
    kk = torch.square(F.relu(dense_apply(cm["wk"], xk)))
    return torch.sigmoid(dense_apply(cm["wr"], xr)) * dense_apply(
        cm["wv"], kk), x[:, :, -1]


def rwkv_block_full(p, x, cfg, chunk: int = 32):
    """x (P, B, S, D) -> (x + block(x), state)."""
    y, (state, xl1) = time_mix_chunked(p["time_mix"],
                                       norm_apply(p["ln1"], x), cfg,
                                       chunk=chunk)
    x = x + y
    y, xl2 = channel_mix(p["channel_mix"], norm_apply(p["ln2"], x))
    x = x + y
    return x, {"state": state, "x_last_tm": xl1, "x_last_cm": xl2}


def rwkv_state_init(cfg, particles: int, batch: int, *, dtype, device,
                    lead=()):
    """An empty state: state (P, *lead, B, H, hd, hd) fp32 zeros, x_last_tm
    and x_last_cm (P, *lead, B, D) zeros."""
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    first = (particles,) + tuple(lead) + (batch,)
    return {"state": torch.zeros(first + (D // hd, hd, hd),
                                 dtype=torch.float32, device=device),
            "x_last_tm": torch.zeros(first + (D,), dtype=dtype,
                                     device=device),
            "x_last_cm": torch.zeros(first + (D,), dtype=dtype,
                                     device=device)}


def rwkv_block_decode(p, x, cfg, st):
    """One recurrent step. x (P, B, 1, D); st as ``rwkv_state_init`` makes
    it (not written). Returns (x + block(x), the new state)."""
    dt = x.dtype
    y, (state, xl1) = time_mix_decode(p["time_mix"], norm_apply(p["ln1"], x),
                                      cfg, st["state"],
                                      st["x_last_tm"].to(dt))
    x = (x + y).to(dt)
    y, xl2 = channel_mix(p["channel_mix"], norm_apply(p["ln2"], x),
                         x_last=st["x_last_cm"].to(dt))
    x = (x + y).to(dt)
    return x, {"state": state,
               "x_last_tm": xl1.to(st["x_last_tm"].dtype),
               "x_last_cm": xl2.to(st["x_last_cm"].dtype)}
