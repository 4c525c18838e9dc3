"""1-D conv UNet — the paper's PDEBench Advection workload, reduced to 1-D
(counterpart of ``repro.models.unet1d``).

Down path: two k = 3 convs a stage, channels doubling, then a stride-2
slice; up path: nearest-neighbour upsample, concatenation with the skip,
two convs. A 1x1 regression head to one channel. ``unet_init`` builds one
particle with the reference's key paths and ``(k, cin, cout)`` weights;
``unet_apply`` takes the stacked tree (leading particle axis P) and one
batch ``u (B, L, 1)`` that every particle sees.

The reference vmaps one particle's convs, which XLA lowers to grouped
convs over the particles. Here every conv is one batched GEMM over P on
shifted views (im2col): activations stay ``(P, B, L, C)`` (NWC) through
the whole forward, and the ``(P, k, cin, cout)`` weight reshapes, with no
copy, to the ``(P, k * cin, cout)`` operand, as ``blocks.dense_apply``
multiplies. ``lax.conv_general_dilated`` is a cross-correlation, as this
is; at stride 1 and k = 3 its "SAME" padding is one zero on each side.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _conv_init(gen, k: int, cin: int, cout: int):
    w = torch.randn((k, cin, cout), generator=gen, device=gen.device) \
        / math.sqrt(k * cin)
    return {"w": w, "b": torch.zeros((cout,), device=gen.device)}


def _conv(p, x):
    """k = 3, stride 1, "SAME": x (P, B, L, cin) -> (P, B, L, cout)."""
    w = p["w"].to(x.dtype)
    P, k, cin, cout = w.shape
    B, L = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1))                       # one zero a side of L
    cols = torch.cat([xp[:, :, i:i + L] for i in range(k)], dim=-1)
    y = torch.baddbmm(p["b"].to(x.dtype)[:, None, :],
                      cols.reshape(P, B * L, k * cin),
                      w.reshape(P, k * cin, cout))
    return y.reshape(P, B, L, cout)


def _head(p, x):
    """The 1x1 conv as a per-position dense, ``x @ w[0] + b`` as the
    reference computes it."""
    w = p["w"].to(x.dtype)[:, 0]                       # (P, cin, cout)
    P, B, L, cin = x.shape
    y = torch.baddbmm(p["b"].to(x.dtype)[:, None, :],
                      x.reshape(P, B * L, cin), w)
    return y.reshape(P, B, L, w.shape[-1])


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def unet_init(gen, cfg):
    """One particle's params, drawn from ``gen`` on ``gen.device``: the
    reference's ``{"enc": (stage, ...), "dec": (stage, ...), "head"}``,
    each stage ``{"c1", "c2"}``, each conv ``{"w": (k, cin, cout), "b":
    (cout,)}`` with ``w ~ N(0, 1) / sqrt(k * cin)`` and ``b = 0``."""
    c0, depth = cfg.d_model, cfg.n_units
    chans = [c0 * (2 ** i) for i in range(depth)]
    enc, dec = [], []
    cin = 1
    for c in chans:
        enc.append({"c1": _conv_init(gen, 3, cin, c),
                    "c2": _conv_init(gen, 3, c, c)})
        cin = c
    for c in reversed(chans):
        dec.append({"c1": _conv_init(gen, 3, cin + c, c),
                    "c2": _conv_init(gen, 3, c, c)})
        cin = c
    return {"enc": tuple(enc), "dec": tuple(dec),
            "head": _conv_init(gen, 1, cin, 1)}


def unet_apply(params, u, cfg):
    """u (B, L, 1) -> (P, B, L, 1)."""
    P = params["head"]["b"].shape[0]
    x = u.expand(P, *u.shape)
    skips = []
    for st in params["enc"]:
        x = _gelu(_conv(st["c1"], x))
        x = _gelu(_conv(st["c2"], x))
        skips.append(x)
        x = x[:, :, ::2]                                    # downsample
    for st, sk in zip(params["dec"], reversed(skips)):
        x = x.repeat_interleave(2, dim=2)[:, :, :sk.shape[2]]   # upsample
        x = torch.cat([x, sk], dim=-1)
        x = _gelu(_conv(st["c1"], x))
        x = _gelu(_conv(st["c2"], x))
    return _head(params["head"], x)
