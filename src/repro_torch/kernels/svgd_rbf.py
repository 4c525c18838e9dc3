"""SVGD's all-to-all: the CUDA kernels' wrappers (``csrc/svgd_rbf.cu``).

The kernels replace the Pallas TPU kernels ``repro.kernels.svgd_rbf``
``pairwise_sqdist`` and ``svgd_force`` and take the store's (n,) row mask
the reference's fused path passes (its Pallas kernels are dense-only):

    pairwise_sqdist(theta, mask=None)                       -> (n, n)
    svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None) -> (n, D)

    theta, grads (n, D) fp32 contiguous; mask (n,) fp32 or None, a dead
    row (mask <= 0) read as zeros and, in the force, written as zeros;
    ktn (n, n) = K^T / n_eff; ksum (n,) = K.sum(0) / n_eff; inv_ell2 a
    one-element fp32 tensor (read on the device: no host sync).

The wrappers take CUDA tensors only and raise on anything else; the CPU
goes through ``kernels.ops`` to the plain versions in ``kernels.ref``.
``<wrapper>.launches`` counts the wrapper's launches in this process (one
per call; ``pairwise_sqdist``'s second, reducing kernel is part of it).
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, entry, raise_on

_BLOCKS = 1056          # 8 blocks per SM on 132 SMs
_THREADS = 256
_TILE = 8
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SQDIST_ARGS = [_P] * 4 + [_I, _L, _L, _I, _P]
_FORCE_ARGS = [_P] * 7 + [_I, _L, _P]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def pairwise_sqdist(theta, mask=None):
    """(n, D) -> (n, n) squared distances (shapes in the module docstring)."""
    if not isinstance(theta, torch.Tensor) or theta.dim() != 2:
        raise ValueError("theta must be an (n, D) tensor")
    n, D = theta.shape
    check("theta", theta, theta.device)
    if mask is not None:
        check("mask", mask, theta.device, (n,))
    out = torch.empty((n, n), dtype=torch.float32, device=theta.device)
    if n == 0:
        return out
    tiles = -(-n // _TILE)
    cols = max(1, -(-D // _THREADS))             # 256-column units
    nchunks = max(1, min(cols, -(-_BLOCKS // (tiles * tiles))))
    chunk = -(-cols // nchunks) * _THREADS
    nchunks = max(1, -(-D // chunk))
    partial = torch.empty((nchunks, n, n), dtype=torch.float32,
                          device=theta.device)
    with torch.cuda.device(theta.device):
        rc = entry("svgd_rbf", "svgd_pairwise_sqdist", _SQDIST_ARGS)(
            theta.data_ptr(), _ptr(mask), partial.data_ptr(), out.data_ptr(),
            n, D, chunk, nchunks, _stream(theta.device))
    raise_on(rc, "pairwise_sqdist")
    pairwise_sqdist.launches += 1
    return out


def svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None):
    """phi (n, D): the SVGD descent direction (module docstring)."""
    if not isinstance(theta, torch.Tensor) or theta.dim() != 2:
        raise ValueError("theta must be an (n, D) tensor")
    n, D = theta.shape
    dev = theta.device
    check("theta", theta, dev)
    check("grads", grads, dev, (n, D))
    check("ktn", ktn, dev, (n, n))
    check("ksum", ksum, dev, (n,))
    check("inv_ell2", inv_ell2.reshape(1) if isinstance(inv_ell2, torch.Tensor)
          else inv_ell2, dev, (1,))
    if mask is not None:
        check("mask", mask, dev, (n,))
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = entry("svgd_rbf", "svgd_force", _FORCE_ARGS)(
            theta.data_ptr(), grads.data_ptr(), ktn.data_ptr(),
            ksum.data_ptr(), inv_ell2.data_ptr(), _ptr(mask), out.data_ptr(),
            n, D, _stream(dev))
    raise_on(rc, "svgd_force")
    svgd_force.launches += 1
    return out


pairwise_sqdist.launches = 0
svgd_force.launches = 0
