"""Dispatch for the ported kernels: CUDA tensors go to the hand-written
kernel, CPU tensors to its plain version. There is no other branch: a
CUDA tensor never falls back to the plain version, and any other device
raises."""
from __future__ import annotations

from . import paged_decode_attention as _paged
from . import ref


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q (P, B, H, hd); pages (P, NP, ps, KVH, hd); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32 -> (P, B, H, hd)."""
    if q.is_cuda:
        return _paged.paged_decode_attention(q, k_pages, v_pages,
                                             block_tables, seq_lens)
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          seq_lens)
    raise ValueError(f"no paged_decode_attention for device {q.device}")
