"""Dispatch for the ported kernels: CUDA tensors go to the hand-written
kernel, CPU tensors to its plain version. There is no other branch: a
CUDA tensor never falls back to the plain version, and any other device
raises. The dry run's fake card tensors (``build.on_card``: fake CUDA
tensors, and fake tensors on the meta device) go to the kernel's
wrapper, whose fake form computes nothing."""
from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import paged_decode_attention as _paged
from . import paged_decode_window_attention as _window
from . import ref
from .build import on_card
from . import svgd_rbf as _svgd
from . import swag_moments as _swag

# every kernel wrapper that counts its launches (``fn.launches``)
COUNTED = (_paged.paged_decode_attention,
           _window.paged_decode_window_attention, _flash.flash_attention,
           _decode.decode_attention, _svgd.pairwise_sqdist, _svgd.svgd_force,
           _swag.moments, _swag.moments_leaves, _swag.diag_std_leaves,
           _swag.diag_std)


def _route(x, kernel, plain, name):
    if on_card(x):
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no {name} for device {x.device}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q (P, B, H, hd); pages (P, NP, ps, KVH, hd); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32 -> (P, B, H, hd)."""
    fn = _route(q, _paged.paged_decode_attention, ref.paged_decode_attention,
                "paged_decode_attention")
    return fn(q, k_pages, v_pages, block_tables, seq_lens)


def paged_decode_window_attention(q, k_pages, v_pages, block_tables,
                                  seq_lens):
    """q (P, B, W, H, hd), query w at position seq_lens[b] + w; pages
    (P, NP, ps, KVH, hd); block_tables (B, n_pmax) int32; seq_lens (B,)
    int32 -> (P, B, W, H, hd)."""
    fn = _route(q, _window.paged_decode_window_attention,
                ref.paged_decode_window_attention,
                "paged_decode_window_attention")
    return fn(q, k_pages, v_pages, block_tables, seq_lens)


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q (P, B, S, H, hd); k, v (P, B, S, KVH, hd) -> (P, B, S, H, hd);
    with ``causal``, keys below ``prefix_len`` are visible to every
    query (the prefix-LM)."""
    fn = _route(q, _flash.flash_attention, ref.flash_attention,
                "flash_attention")
    return fn(q, k, v, causal=causal, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, k_pos):
    """q (P, B, H, hd); caches (P, B, C, KVH, hd); k_pos (B, C) int32
    -> (P, B, H, hd)."""
    fn = _route(q, _decode.decode_attention, ref.decode_attention,
                "decode_attention")
    return fn(q, k_cache, v_cache, k_pos)


def pairwise_sqdist(theta, mask=None):
    """theta (n, D) -> (n, n) squared distances; dead rows read as 0."""
    fn = _route(theta, _svgd.pairwise_sqdist, ref.pairwise_sqdist,
                "pairwise_sqdist")
    return fn(theta, mask)


def svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None, *, out=None):
    """(n, D) SVGD force from the (n, n) kernel glue; dead rows give 0.
    ``out`` (n, D) fp32, when given, receives it in place."""
    fn = _route(theta, _svgd.svgd_force, ref.svgd_force, "svgd_force")
    return fn(theta, grads, ktn, ksum, inv_ell2, mask, out=out)


def swag_moments_leaves(means, sqs, thetas, n, mask=None, devs=None,
                        slot=None):
    """``swag_moments`` over every leaf of a tree (lists of (P, ...)
    leaves, devs (P, R, ...) each), in place, one kernel launch per
    ``swag_moments.MAX_LEAVES`` leaves. Params of another dtype than fp32
    (bf16 masters) go through ``swag_moments.leaves_via_fp32``: still
    one launch, on fp32 copies of the params."""
    fn = _route(means[0], _swag.moments_leaves, ref.swag_moments_leaves,
                "swag_moments_leaves")
    if any(t.dtype != torch.float32 for t in thetas):
        return _swag.leaves_via_fp32(fn, means, sqs, thetas, n, mask, devs,
                                     slot)
    return fn(means, sqs, thetas, n, mask, devs, slot)


def diag_std_leaves(means, sqs):
    """``diag_std`` of every leaf of a tree (lists of tensors), one kernel
    launch per ``swag_moments.MAX_LEAVES`` non-empty leaves: a list of
    scales shaped like the means (the sampling path's dispatch)."""
    fn = _route(means[0], _swag.diag_std_leaves, ref.diag_std_leaves,
                "diag_std_leaves")
    return fn(means, sqs)
