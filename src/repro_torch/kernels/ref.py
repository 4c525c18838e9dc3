"""Plain PyTorch versions of the ported kernels (the allclose targets).

Ported from ``repro.kernels.ref`` with the particle axis explicit, as the
CUDA kernels take it. The CPU path runs these; on the card they are the
reference each kernel is held against.

The decode attention functions zero the value rows of invalid columns as
well as their weights, like the single-token TPU kernels do: stale slots
past a sequence's tail may hold NaN, and ``0 * NaN`` would leak it into
the output. The SVGD
and SWAG functions take the store's row mask the same way: a dead row is
selected away (``where``), never multiplied, so NaN in a padding slot
cannot leak.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, k_pos, *, softcap: float = 0.0):
    """q (P, B, H, hd); caches (P, B, C, KVH, hd); k_pos (B, C) int, the
    absolute position of each cache slot (-1 = empty) -> (P, B, H, hd).
    Softmax and products in fp32; the output takes the dtype of q. With
    ``softcap`` > 0 the scores are capped to ``softcap * tanh(s /
    softcap)`` first (the reference's jnp decode form; no kernel takes
    a softcap)."""
    P, B, H, hd = q.shape
    KVH = k_cache.shape[3]
    G = H // KVH
    qq = (q.float() / math.sqrt(hd)).reshape(P, B, KVH, G, hd)
    valid = k_pos >= 0                                        # (B, C)
    s = torch.einsum("pbngh,pbknh->pbngk", qq, k_cache.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[None, :, None, None, :], p, 0.0)
    v = torch.where(valid[None, :, :, None, None], v_cache.float(), 0.0)
    o = torch.einsum("pbngk,pbknh->pbngh", p, v)
    return o.reshape(P, B, H, hd).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q (P, B, H, hd); pages (P, NP, ps, KVH, hd); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32 (-1 = inactive row)
    -> (P, B, H, hd).

    Gathers each row's pages to a dense cache and reuses the dense
    version; inactive rows return zeros."""
    P, B = q.shape[:2]
    ps = k_pages.shape[2]
    n_pmax = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[:, bt].reshape(P, B, n_pmax * ps, *k_pages.shape[3:])
    v = v_pages[:, bt].reshape(P, B, n_pmax * ps, *v_pages.shape[3:])
    col = torch.arange(n_pmax * ps, device=q.device)[None, :]
    pos = torch.where(col <= seq_lens[:, None].long(), col, -1)
    out = decode_attention(q, k, v, pos)
    return torch.where((seq_lens >= 0)[None, :, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_decode_window_attention(q, k_pages, v_pages, block_tables,
                                  seq_lens):
    """q (P, B, W, H, hd), window query w at absolute position
    ``seq_lens[b] + w``; pages (P, NP, ps, KVH, hd); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32, the position of query 0
    (-1 = inactive row) -> (P, B, W, H, hd).

    Query w sees columns 0..seq_lens[b] + w. Each window position is the
    single-token version at its own limit, so both the weights and the
    value rows of the columns it may not see are zeroed for it (the
    reference's oracle zeroes only the weights)."""
    P, B, W = q.shape[:3]
    ps = k_pages.shape[2]
    n_pmax = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[:, bt].reshape(P, B, n_pmax * ps, *k_pages.shape[3:])
    v = v_pages[:, bt].reshape(P, B, n_pmax * ps, *v_pages.shape[3:])
    col = torch.arange(n_pmax * ps, device=q.device)[None, :]
    sl = seq_lens[:, None].long()
    outs = [decode_attention(q[:, :, w], k, v,
                             torch.where(col <= sl + w, col, -1))
            for w in range(W)]
    out = torch.stack(outs, dim=2)
    return torch.where((seq_lens >= 0)[None, :, None, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q (P, B, S, H, hd); k, v (P, B, S, KVH, hd) -> (P, B, S, H, hd).
    Causal, prefix-LM (causal with ``prefix_len`` > 0: key j visible to
    query i iff j <= i or j < prefix_len) or bidirectional GQA softmax
    attention; softmax and products in fp32, the output in the dtype of
    q."""
    P, B, S, H, hd = q.shape
    KVH = k.shape[3]
    qq = q.float().reshape(P, B, S, KVH, H // KVH, hd) / math.sqrt(hd)
    s = torch.einsum("pbqngh,pbknh->pbngqk", qq, k.float())
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        keep[:, :prefix_len] = True
        s = s.masked_fill(~keep, NEG_INF)
    o = torch.einsum("pbngqk,pbknh->pbqngh", torch.softmax(s, dim=-1),
                     v.float())
    return o.reshape(P, B, S, H, hd).to(q.dtype)


def _live(mask, x):
    """(P,) mask -> bool tensor broadcast against x (P, ...)."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1)) > 0


def pairwise_sqdist(theta, mask=None):
    """theta (n, D) -> (n, n) squared distances, the reference oracle's
    Gram form clamped at 0; dead rows read as zeros."""
    if mask is not None:
        theta = torch.where(_live(mask, theta), theta, 0.0)
    sq = (theta * theta).sum(1)
    return (sq[:, None] + sq[None, :] - 2.0 * theta @ theta.T).clamp(min=0.0)


def svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None, *, out=None):
    """phi = ktn @ g - (ksum * theta - ktn @ theta) * inv_ell2, the TPU
    force kernel's formula; theta, grads (n, D), ktn (n, n) = K^T / n_eff,
    ksum (n,) = K.sum(0) / n_eff. Dead rows read as zeros and come out as
    exact zeros. ``out`` (n, D), when given, receives phi."""
    if mask is not None:
        live = _live(mask, theta)
        theta = torch.where(live, theta, 0.0)
        grads = torch.where(live, grads, 0.0)
    phi = ktn @ grads - (ksum[:, None] * theta - ktn @ theta) * inv_ell2
    if mask is not None:
        phi = torch.where(live, phi, 0.0)
    return phi if out is None else out.copy_(phi)


def swag_moments(mean, sq, theta, n, mask=None, dev=None, slot=None,
                 out_mean=None, out_sq=None):
    """One SWAG collection over stacked rows: mean, sq, theta (P, ...),
    n (P,) -> (mean', sq') = ((mean n + theta)/(n+1), (sq n + theta^2)/
    (n+1)); dead rows keep their values. With dev (P, R, ...) and slot
    (P,) int32, ``dev[p, slot[p]] = theta - mean'`` for the live rows, in
    place. ``out_mean`` / ``out_sq`` (which may be ``mean`` / ``sq``)
    receive mean' / sq' when given."""
    nn = n.reshape(n.shape + (1,) * (mean.dim() - 1))
    new_mean = (mean * nn + theta) / (nn + 1)
    new_sq = (sq * nn + theta * theta) / (nn + 1)
    if mask is not None:
        live = _live(mask, mean)
        new_mean = torch.where(live, new_mean, mean)
        new_sq = torch.where(live, new_sq, sq)
    if dev is not None:
        rows = torch.arange(mean.shape[0], device=mean.device)
        slot = slot.long()
        deviation = theta - new_mean
        if mask is not None:
            deviation = torch.where(live, deviation, dev[rows, slot])
        dev[rows, slot] = deviation
    if out_mean is not None:
        new_mean = out_mean.copy_(new_mean)
    if out_sq is not None:
        new_sq = out_sq.copy_(new_sq)
    return new_mean, new_sq


def swag_moments_leaves(means, sqs, thetas, n, mask=None, devs=None,
                        slot=None):
    """``swag_moments`` over every leaf of a tree, in place (the one-launch
    kernel's plain version): lists of (P, ...) leaves, devs (P, R, ...)
    each. Returns (means, sqs)."""
    for i, (m, s, t) in enumerate(zip(means, sqs, thetas)):
        swag_moments(m, s, t, n, mask, None if devs is None else devs[i],
                     slot, out_mean=m, out_sq=s)
    return means, sqs


def diag_std(mean, sq):
    """sqrt(max(sq - mean^2, 1e-30)), the SWAG diagonal scale."""
    return torch.sqrt(torch.clamp(sq - mean * mean, min=1e-30))


def diag_std_leaves(means, sqs):
    """``diag_std`` of every leaf of a tree (the one-launch kernel's plain
    version): a list of scales shaped like ``means``."""
    return [diag_std(m, s) for m, s in zip(means, sqs)]
