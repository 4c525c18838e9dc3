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

The page walk of each row is split across blocks. ``split_plan`` fixes
the split count and a floor of pages per split from ``n_pmax``, ``ps``
and ``W`` alone (the host never reads ``seq_lens``, which would cost a
device sync per verify); ``split_ranges`` is the rule by which the
kernel gives each split its pages once it reads a row's ``seq_len``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import entry, raise_on
from .paged_decode_attention import DTYPE_CODE, check_paged

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
STAGE_COLS = 32        # columns a block stages at a time (about)
MAX_SPLITS = 8         # splits per (kv head, row, particle)
MAX_ENTRIES = 4096     # W * G * hd: accumulator entries a block keeps


def split_plan(n_pmax: int, ps: int, W: int):
    """(pages per stage, floor of pages per split, number of splits).

    A stage holds about ``STAGE_COLS`` columns; a split holds at least one
    stage and one whole window, and there are at most ``MAX_SPLITS`` of
    them, fewer when ``n_pmax`` pages fill fewer floors."""
    stage = max(1, STAGE_COLS // ps)
    floor = max(stage, -(-W // ps))
    return stage, floor, max(1, min(MAX_SPLITS, -(-n_pmax // floor)))


def split_ranges(plan, seq_len: int, W: int, ps: int, n_pmax: int):
    """The pages [start, stop) that each split of a row reads (the kernel's
    rule): a row with ``n_live`` live pages gives each split
    ``max(floor, ceil(n_live / n_splits))`` of them in order; splits past
    the live pages, and every split of an inactive row, get none."""
    _, floor, n_splits = plan
    if seq_len < 0:
        return [(0, 0)] * n_splits
    n_live = min((seq_len + W - 1) // ps + 1, n_pmax)
    pps = max(floor, -(-n_live // n_splits))
    return [(min(s * pps, n_live), min((s + 1) * pps, n_live))
            for s in range(n_splits)]


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
    if W * (H // KVH) * hd > MAX_ENTRIES:
        raise ValueError(f"needs W * (H / KVH) * hd <= {MAX_ENTRIES}; got W "
                         f"{W}, H {H}, KVH {KVH}, hd {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stage, floor, n_splits = split_plan(n_pmax, ps, W)
    scratch = torch.empty(
        P * B * KVH * n_splits * W * (H // KVH) * (hd + 2) if n_splits > 1
        else 1, dtype=torch.float32, device=q.device)
    fn = entry("paged_decode_window_attention",
               "paged_decode_window_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), P, B, W, H, KVH, hd, NP, ps, n_pmax,
                k_pages.stride(0), DTYPE_CODE[q.dtype],
                DTYPE_CODE[k_pages.dtype], 1.0 / math.sqrt(hd), stage, floor,
                n_splits, stream)
    raise_on(rc, "paged_decode_window_attention")
    paged_decode_window_attention.launches += 1
    return out


paged_decode_window_attention.launches = 0
