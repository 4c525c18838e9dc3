"""Paged single-token decode attention: the CUDA kernel's wrapper.

The kernel (``csrc/paged_decode_attention.cu``) replaces the Pallas TPU
kernel ``repro.kernels.paged_decode_attention.paged_decode_attention``.
The reference vmaps that kernel over the ParticleStore's capacity axis; a
CUDA launch cannot be vmapped, so here the particle axis is explicit:

    q            (P, B, H, hd)            fp32 or bf16
    k/v_pages    (P, NP, ps, KVH, hd)     fp32 or bf16 (a particle-strided
                                          view is fine: the inner four dims
                                          must be contiguous)
    block_tables (B, n_pmax) int32        shared by all particles
    seq_lens     (B,) int32               last valid position, -1 inactive
    -> (P, B, H, hd), dtype of q; inactive rows are exact zeros.

The wrapper takes CUDA tensors only and raises on anything else; the CPU
goes through ``kernels.ops``, which sends CPU tensors to the plain version
in ``kernels.ref``. ``paged_decode_attention.launches`` counts the calls
that launched the kernel (its split pass and its combine pass, launched
when the plan has more than one split, count as one).

The kernel is the drafted-window kernel at W = 1: the same split page
walk (``kernels.split_walk``), the same plan, the same bits.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..obs import device as _obs
from . import split_walk
from .build import entry, is_fake, on_card, raise_on

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def check_paged(q, k_pages, v_pages, block_tables, seq_lens, *,
                window: bool = False):
    """Validate the arguments of the paged kernels: q is (P, B, H, hd), or
    (P, B, W, H, hd) with ``window``; raises ValueError on anything the
    kernels do not take."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if not on_card(t) or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
    layout = "(P, B, W, H, hd)" if window else "(P, B, H, hd)"
    if q.dim() != 4 + window or k_pages.dim() != 5:
        raise ValueError(f"q must be {layout} and pages (P, NP, ps, KVH, hd); "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    P, B, H, hd = q.shape[0], q.shape[1], q.shape[-2], q.shape[-1]
    _, NP, ps, KVH, hd_kv = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[0] != P \
            or hd_kv != hd or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    if q.dtype not in DTYPE_CODE or k_pages.dtype not in DTYPE_CODE \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"dtypes must be float32 or bfloat16 with k and v "
                         f"alike; got q {q.dtype}, k {k_pages.dtype}, "
                         f"v {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables must be ({B}, n_pmax) and seq_lens "
                         f"({B},); got {tuple(block_tables.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    # the kernels index pages as contiguous past the particle axis; the
    # stride of a size-1 dim is never used, so views may carry any there
    inner = (ps * KVH * hd, KVH * hd, hd, 1)
    for t in (k_pages, v_pages):
        if any(n > 1 and s != want for n, s, want in
               zip(t.shape[1:], t.stride()[1:], inner)):
            raise ValueError("k/v pages must be contiguous past the "
                             "particle axis")
    if P > 1 and k_pages.stride(0) != v_pages.stride(0):
        raise ValueError("k and v pages must share one particle stride")


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Launch the CUDA kernel (shapes in the module docstring)."""
    check_paged(q, k_pages, v_pages, block_tables, seq_lens)
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    P, B, H, hd = q.shape
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
        n_pmax, ps, 1, G, KVH, P, B, hd, k_pages.element_size(),
        split_walk.sm_count(q.device))
    scratch = split_walk.scratch(plan, P, B, KVH, G, hd, q.device)
    fn = entry("paged_decode_attention", "paged_decode_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), P, B, H, KVH, hd, NP, ps, n_pmax,
                k_pages.stride(0), DTYPE_CODE[q.dtype],
                DTYPE_CODE[k_pages.dtype], 1.0 / math.sqrt(hd), heads,
                row_blocks, *plan, stream)
    raise_on(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    if _obs.counting_now():
        _obs.charge(*cost(q, k_pages, v_pages, block_tables, seq_lens),
                    device=q.device)
    return out


paged_decode_attention.launches = 0


def host_lens(seq_lens):
    """The live rows' lengths, read on the host outside any open count."""
    with _disable_current_modes():
        return [L for L in seq_lens.tolist() if L >= 0]


def cost(q, k_pages, v_pages, block_tables, seq_lens):
    """(FLOPs, bytes) of one launch on this call's data: each live K/V row
    read once, q read and out written once, each row's live block-table
    entries and its length; 4 FLOPs a (query head, key, dim). Reads
    ``seq_lens`` on the host, outside any count that is open; a fake
    ``seq_lens`` (the dry run) has no values, and every row counts at its
    block table's full length."""
    P, _, H, hd = q.shape
    ps, KVH = k_pages.shape[2], k_pages.shape[3]
    lens = ([block_tables.shape[1] * ps - 1] * seq_lens.numel()
            if is_fake(seq_lens) else host_lens(seq_lens))
    live = sum(L + 1 for L in lens)
    pages = sum(L // ps + 1 for L in lens)
    nbytes = (P * live * KVH * hd * 2 * k_pages.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (pages + seq_lens.numel()))
    return 4 * P * live * H * hd, nbytes
