"""Blocked online-softmax attention forward (prefill): the CUDA kernel's
wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.attention.flash_attention``. The reference runs one
particle at a time; here the particle axis is explicit and the kernel
folds it into the batch:

    q     (P, B, S, H, hd)     fp32 or bf16
    k, v  (P, B, S, KVH, hd)   the dtype of q
    -> (P, B, S, H, hd), the dtype of q; causal (key j visible to query
       i iff j <= i), causal with a bidirectional prefix (``prefix_len``
       > 0, the prefix-LM: key j visible to query i iff j <= i or
       j < prefix_len) or bidirectional; H a multiple of KVH with
       H / KVH <= 64; hd <= 256.

Forward only: the training attention, which needs a gradient, stays the
plain version under autograd (the JAX package has no backward kernel
either). The wrapper takes CUDA tensors only and raises on anything
else; the CPU goes through ``kernels.ops`` to the plain version in
``kernels.ref``. ``flash_attention.launches`` counts the kernel launches
of this process.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..obs import device as _obs
from .build import check, entry, is_fake, raise_on
from .paged_decode_attention import DTYPE_CODE

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_MAX_GROUP = 64
_MAX_HD = 256


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """Launch the CUDA kernel (shapes in the module docstring).
    ``prefix_len`` is read only when ``causal``."""
    if not isinstance(q, torch.Tensor) or q.dim() != 5:
        raise ValueError("q must be a (P, B, S, H, hd) tensor")
    P, B, S, H, hd = q.shape
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    check("q", q, q.device, dtype=q.dtype)
    if k.dim() != 5 or k.shape[:3] != q.shape[:3] or k.shape[4] != hd:
        raise ValueError(f"k must be (P, B, S, KVH, hd) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}")
    KVH = k.shape[3]
    check("k", k, q.device, dtype=q.dtype)
    check("v", v, q.device, k.shape, dtype=q.dtype)
    if H % KVH or H // KVH > _MAX_GROUP or hd > _MAX_HD:
        raise ValueError(f"needs H % KVH == 0, H / KVH <= {_MAX_GROUP} and "
                         f"hd <= {_MAX_HD}; got H {H}, KVH {KVH}, hd {hd}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if is_fake(q):                       # the fake form (kernels.build)
        if _obs.counting_now():
            _obs.charge(*cost(q, k, v, causal=causal, prefix_len=prefix_len),
                        device=q.device)
        return out
    fn = entry("flash_attention", "flash_attention", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                P * B, S, H, KVH, hd, int(causal), int(prefix_len),
                DTYPE_CODE[q.dtype],
                1.0 / math.sqrt(hd), stream)
    raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    if _obs.counting_now():
        _obs.charge(*cost(q, k, v, causal=causal, prefix_len=prefix_len),
                    device=q.device)
    return out


flash_attention.launches = 0


def visible_pairs(S: int, causal: bool = True, prefix_len: int = 0) -> int:
    """The (query, key) pairs a sequence's mask lets through: S(S+1)/2
    causal, plus the prefix's keys above the diagonal, p(p-1)/2 for
    p = min(prefix_len, S); S^2 without the mask."""
    if not causal:
        return S * S
    p = min(prefix_len, S)
    return S * (S + 1) // 2 + p * (p - 1) // 2


def cost(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """(FLOPs, bytes) of one launch: q, k, v read and out written once;
    4 FLOPs a (query head, key, dim) over the sequence's visible pairs
    (``visible_pairs``). The 3xTF32 products of an fp32 launch are one
    FLOP each here, as the operation bound counts them."""
    P, B, S, H, hd = q.shape
    pairs = visible_pairs(S, causal, prefix_len)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return 4 * P * B * H * hd * pairs, nbytes
