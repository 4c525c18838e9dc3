"""Plain PyTorch versions of the ported kernels (the allclose targets).

Ported from ``repro.kernels.ref`` with the particle axis explicit, as the
CUDA kernels take it. The CPU path runs these; on the card they are the
reference each kernel is held against. Both functions zero the value rows
of invalid columns as well as their weights, like the TPU kernel does:
stale slots past a sequence's tail may hold NaN, and ``0 * NaN`` would
leak it into the output.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, k_pos):
    """q (P, B, H, hd); caches (P, B, C, KVH, hd); k_pos (B, C) int, the
    absolute position of each cache slot (-1 = empty) -> (P, B, H, hd).
    Softmax and products in fp32; the output takes the dtype of q."""
    P, B, H, hd = q.shape
    KVH = k_cache.shape[3]
    G = H // KVH
    qq = (q.float() / math.sqrt(hd)).reshape(P, B, KVH, G, hd)
    valid = k_pos >= 0                                        # (B, C)
    s = torch.einsum("pbngh,pbknh->pbngk", qq, k_cache.float())
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
