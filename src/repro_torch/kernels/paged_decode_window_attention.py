"""Paged drafted-window attention (speculative verify): the CUDA kernel's
wrapper.

The kernel (``csrc/paged_decode_window_attention.cu``) replaces the
Pallas TPU kernel
``repro.kernels.paged_decode_attention.paged_decode_window_attention``.
The reference vmaps that kernel over the ParticleStore's capacity axis;
here the particle axis is explicit:

    q            (P, B, W, H, hd)         fp32 or bf16; window query w of
                                          row b at position seq_lens[b] + w
    k/v_pages    (P, NP, ps, KVH, hd)     fp32 or bf16 (a particle-strided
                                          view is fine: the inner four dims
                                          must be contiguous)
    block_tables (B, n_pmax) int32        shared by all particles
    seq_lens     (B,) int32               position of query 0, -1 inactive
    -> (P, B, W, H, hd), dtype of q; inactive rows are exact zeros.

Query w sees columns 0..seq_lens[b] + w; a column it may not see adds
neither weight nor value (the TPU kernel zeroes only the weight). The
wrapper takes CUDA tensors only and raises on anything else; the CPU goes
through ``kernels.ops``, which sends CPU tensors to the plain version in
``kernels.ref``. ``paged_decode_window_attention.launches`` counts the
calls that launched the kernel (its split pass and its combine pass,
launched when the plan has more than one split, count as one).

The page walk of each row is split across blocks by the plan of
``kernels.split_walk``; at W = 1 the kernel is ``paged_decode_attention``,
bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..obs import device as _obs
from . import split_walk
from .build import entry, is_fake, raise_on
from .paged_decode_attention import DTYPE_CODE, check_paged, host_lens

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def paged_decode_window_attention(q, k_pages, v_pages, block_tables,
                                  seq_lens):
    """Launch the CUDA kernel (shapes in the module docstring)."""
    check_paged(q, k_pages, v_pages, block_tables, seq_lens, window=True)
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    P, B, W, H, hd = q.shape
    _, NP, ps, KVH, _ = k_pages.shape
    n_pmax = block_tables.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if is_fake(q):                       # the fake form (kernels.build)
        if _obs.counting_now():
            _obs.charge(*cost(q, k_pages, v_pages, block_tables, seq_lens),
                        device=q.device)
        return out
    G = H // KVH
    plan, heads, row_blocks = split_walk.launch_plan(
        n_pmax, ps, W, G, KVH, P, B, hd, k_pages.element_size(),
        split_walk.sm_count(q.device))
    scratch = split_walk.scratch(plan, P, B, KVH, W * G, hd, q.device)
    fn = entry("paged_decode_window_attention",
               "paged_decode_window_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), P, B, W, H, KVH, hd, NP, ps, n_pmax,
                k_pages.stride(0), DTYPE_CODE[q.dtype],
                DTYPE_CODE[k_pages.dtype], 1.0 / math.sqrt(hd), heads,
                row_blocks, *plan, stream)
    raise_on(rc, "paged_decode_window_attention")
    paged_decode_window_attention.launches += 1
    if _obs.counting_now():
        _obs.charge(*cost(q, k_pages, v_pages, block_tables, seq_lens),
                    device=q.device)
    return out


paged_decode_window_attention.launches = 0


def cost(q, k_pages, v_pages, block_tables, seq_lens):
    """(FLOPs, bytes) of one launch on this call's data: each active
    row's live pages read once per window (its prefix and the window's W
    positions), q read and out written once, the block-table entries and
    lengths; 4 FLOPs a (query head, key, dim) over the causal window's
    (query, key) pairs. Reads ``seq_lens`` on the host, outside any open
    count; a fake ``seq_lens`` (the dry run) has no values, and every
    row's window ends at its block table's last slot."""
    P, _, W, H, hd = q.shape
    ps, KVH = k_pages.shape[2], k_pages.shape[3]
    lens = ([block_tables.shape[1] * ps - W] * seq_lens.numel()
            if is_fake(seq_lens) else host_lens(seq_lens))
    pairs = sum(W * L + W * (W + 1) // 2 for L in lens)
    live = sum(L + W for L in lens)
    pages = sum((L + W - 1) // ps + 1 for L in lens)
    nbytes = (P * live * KVH * hd * 2 * k_pages.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (pages + seq_lens.numel()))
    return 4 * P * pairs * H * hd, nbytes
