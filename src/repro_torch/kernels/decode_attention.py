"""Single-token decode attention over a dense KV cache: the CUDA kernel's
wrapper.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention``. The reference vmaps
that kernel over the ParticleStore's capacity axis; here the particle
axis is explicit:

    q        (P, B, H, hd)          fp32 or bf16
    k/v      (P, B, C, KVH, hd)     fp32 or bf16, contiguous past the
                                    particle axis (a unit's view of a
                                    stacked cache is fine)
    k_pos    (B, C) int32           absolute position of each slot (-1 =
                                    empty), shared by all particles
    -> (P, B, H, hd), dtype of q; a row with no valid slot gives zeros.

The wrapper takes CUDA tensors only and raises on anything else; the CPU
goes through ``kernels.ops``, which sends CPU tensors to the plain version
in ``kernels.ref``. ``decode_attention.launches`` counts the calls that
launched the kernel (its split pass and its combine pass, launched when
the plan has more than one split, count as one).

The kernel walks each row's C slots by the split walk of
``kernels.split_walk``, with a plan from C and the grid's size
(``launch_plan``): the host never reads ``k_pos``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..obs import device as _obs
from . import split_walk
from .build import check, entry, is_fake, raise_on
from .paged_decode_attention import DTYPE_CODE

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def decode_attention(q, k_cache, v_cache, k_pos):
    """Launch the CUDA kernel (shapes in the module docstring)."""
    if not isinstance(q, torch.Tensor) or q.dim() != 4 \
            or k_cache.dim() != 5:
        raise ValueError("q must be (P, B, H, hd) and the caches "
                         "(P, B, C, KVH, hd)")
    P, B, H, hd = q.shape
    C, KVH = k_cache.shape[2], k_cache.shape[3]
    if q.dtype not in DTYPE_CODE or k_cache.dtype not in DTYPE_CODE:
        raise ValueError(f"dtypes must be float32 or bfloat16; got q "
                         f"{q.dtype}, k {k_cache.dtype}")
    if k_cache.shape[:2] != (P, B) or k_cache.shape[4] != hd or H % KVH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}")
    check("q", q, q.device, dtype=q.dtype)
    check("k_cache", k_cache[0], q.device, dtype=k_cache.dtype)
    check("v_cache", v_cache[0], q.device, k_cache.shape[1:],
          dtype=k_cache.dtype)
    if v_cache.shape != k_cache.shape or (
            P > 1 and k_cache.stride(0) != v_cache.stride(0)):
        raise ValueError("k and v caches must share one shape and one "
                         "particle stride")
    check("k_pos", k_pos, q.device, (B, C), dtype=torch.int32)
    out = torch.empty_like(q)
    if out.numel() == 0 or C == 0:
        return out.zero_()
    if is_fake(q):                       # the fake form (kernels.build)
        if _obs.counting_now():
            _obs.charge(*cost(q, k_cache, v_cache, k_pos), device=q.device)
        return out
    G = H // KVH
    plan, heads, row_blocks = split_walk.launch_plan(
        C, 1, 1, G, KVH, P, B, hd, k_cache.element_size(),
        split_walk.sm_count(q.device))
    scratch = split_walk.scratch(plan, P, B, KVH, G, hd, q.device)
    fn = entry("decode_attention", "decode_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_pos.data_ptr(), out.data_ptr(), scratch.data_ptr(), P, B, H,
                KVH, hd, C, k_cache.stride(0), DTYPE_CODE[q.dtype],
                DTYPE_CODE[k_cache.dtype], 1.0 / math.sqrt(hd), heads,
                row_blocks, *plan, stream)
    raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    if _obs.counting_now():
        _obs.charge(*cost(q, k_cache, v_cache, k_pos), device=q.device)
    return out


decode_attention.launches = 0


def cost(q, k_cache, v_cache, k_pos):
    """(FLOPs, bytes) of one launch on this call's data: each valid slot's
    K/V read once, q read and out written once, ``k_pos`` read; 4 FLOPs a
    (query head, valid slot, dim). Reads ``k_pos`` on the host, outside
    any count that is open (the read is the cost's, not the kernel's); a
    fake ``k_pos`` (the dry run) has no values, and every slot counts as
    valid: a decode over a full cache."""
    P, _, H, hd = q.shape
    KVH = k_cache.shape[3]
    if is_fake(k_pos):
        valid = k_pos.numel()
    else:
        with _disable_current_modes():
            valid = int((k_pos >= 0).sum())
    nbytes = (P * valid * KVH * hd * 2 * k_cache.element_size()
              + 2 * q.numel() * q.element_size() + 4 * k_pos.numel())
    return 4 * P * valid * H * hd, nbytes
