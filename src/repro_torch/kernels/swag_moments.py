"""SWAG moment passes: the CUDA kernels' wrappers (``csrc/swag_moments.cu``).

The kernels replace the Pallas TPU kernels ``repro.kernels.swag_moments``
``moments_flat`` and ``diag_std_flat``. They run over the store's stacked
rows, one leaf at a time (no flatten copy):

    moments(mean, sq, theta, n, mask=None, dev=None, slot=None,
            out_mean=None, out_sq=None)
        mean, sq, theta (P, ...) fp32 contiguous; n (P,) fp32 per row;
        mask (P,) fp32 or None -> (mean', sq'); a dead row is copied
        through bit for bit. With dev (P, R, ...) and slot (P,) int32 the
        live rows' deviations theta - mean' land in dev[p, slot[p]], in
        place. mean' and sq' are written into ``out_mean`` and ``out_sq``
        when given (new tensors otherwise); ``out_mean=mean, out_sq=sq``
        updates the moments in place.
    diag_std(mean, sq) -> sqrt(max(sq - mean^2, 1e-30)), any shape.

The wrappers take CUDA tensors only and raise on anything else; the CPU
goes through ``kernels.ops`` to the plain versions in ``kernels.ref``.
``<wrapper>.launches`` counts the wrapper's launches in this process.

The kernels are fp32 only. Under bf16 masters the SWAG moments stay fp32
and the params and the deviation ring are bf16 (``bdl.swag``);
``kernels.ops`` then runs the moments kernel (or its plain version) on
the params widened to fp32 through ``moments_via_fp32``, as the
reference's ``update_moments`` widens its inputs, and writes the ring
there.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import device as _obs
from .build import check, entry, raise_on

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MOMENTS_ARGS = [_P] * 7 + [_I] + [_P] * 2 + [_I, _L, _P]
_DIAG_STD_ARGS = [_P] * 3 + [_L, _P]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _out(name, out, own, others):
    """The output tensor of one moment: ``out`` (checked to be ``own``
    itself or to share no address with the other inputs) or a new one."""
    if out is None:
        return torch.empty_like(own)
    check(name, out, own.device, tuple(own.shape))
    if out.data_ptr() != own.data_ptr() and any(
            out.data_ptr() == o.data_ptr() for o in others):
        raise ValueError(f"{name} may alias its own moment, nothing else")
    return out


def moments(mean, sq, theta, n, mask=None, dev=None, slot=None,
            out_mean=None, out_sq=None):
    """One SWAG collection over one leaf's stacked rows (module docstring)."""
    if not isinstance(mean, torch.Tensor) or mean.dim() < 1:
        raise ValueError("mean must be a (P, ...) tensor")
    device, shape = mean.device, tuple(mean.shape)
    P = shape[0]
    L = mean[0].numel() if P else 0
    check("mean", mean, device)
    check("sq", sq, device, shape)
    check("theta", theta, device, shape)
    check("n", n, device, (P,))
    if mask is not None:
        check("mask", mask, device, (P,))
    if (dev is None) != (slot is None):
        raise ValueError("pass dev and slot together")
    R = 0
    if dev is not None:
        if dev.dim() < 2:
            raise ValueError("dev must be (P, R, ...)")
        R = dev.shape[1]
        check("dev", dev, device, (P, R) + shape[1:])
        check("slot", slot, device, (P,), torch.int32)
    if P > 65535:
        raise ValueError(f"at most 65535 rows, got {P}")
    out_mean = _out("out_mean", out_mean, mean, (sq, theta))
    out_sq = _out("out_sq", out_sq, sq, (mean, theta))
    if mean.numel() == 0:
        return out_mean, out_sq
    with torch.cuda.device(device):
        rc = entry("swag_moments", "swag_moments", _MOMENTS_ARGS)(
            mean.data_ptr(), sq.data_ptr(), theta.data_ptr(), n.data_ptr(),
            _ptr(mask), _ptr(dev), _ptr(slot), R,
            out_mean.data_ptr(), out_sq.data_ptr(), P, L,
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(rc, "swag moments")
    moments.launches += 1
    if _obs.counting_now():
        _obs.charge(*moments_cost(mean, dev))
    return out_mean, out_sq


def diag_std(mean, sq):
    """sqrt(max(sq - mean^2, 1e-30)) elementwise (module docstring)."""
    if not isinstance(mean, torch.Tensor):
        raise ValueError("mean must be a tensor")
    check("mean", mean, mean.device)
    check("sq", sq, mean.device, tuple(mean.shape))
    out = torch.empty_like(mean)
    if out.numel() == 0:
        return out
    with torch.cuda.device(mean.device):
        rc = entry("swag_moments", "swag_diag_std", _DIAG_STD_ARGS)(
            mean.data_ptr(), sq.data_ptr(), out.data_ptr(), mean.numel(),
            torch.cuda.current_stream(mean.device).cuda_stream)
    raise_on(rc, "swag diag_std")
    diag_std.launches += 1
    if _obs.counting_now():
        _obs.charge(*diag_std_cost(mean))
    return out


moments.launches = 0
diag_std.launches = 0


def moments_cost(mean, dev=None):
    """(FLOPs, bytes) of one ``moments`` launch: mean, sq and theta read,
    mean and sq written, and the deviation row written when the ring is
    given; 7 FLOPs an entry."""
    nbytes = mean.numel() * mean.element_size()
    return 7 * mean.numel(), (5 + (dev is not None)) * nbytes


def diag_std_cost(mean):
    """(FLOPs, bytes) of one ``diag_std``: mean and sq read, the scale
    written; 4 FLOPs an entry."""
    return 4 * mean.numel(), 3 * mean.numel() * mean.element_size()


def moments_via_fp32(fn, mean, sq, theta, n, mask=None, dev=None, slot=None,
                     out_mean=None, out_sq=None):
    """``moments`` under bf16 masters: the moments are fp32
    (``bdl.swag.swag_state_init``), theta and the deviation ring are not.
    ``fn`` (the kernel or its plain version) runs on theta widened to
    fp32, and a live row's deviation lands in ``dev[p, slot[p]]`` here,
    as ``theta - mean'`` in fp32 cast to the ring's dtype (the
    reference's ``(p - m).astype(d.dtype)`` with its fp32 moments); dead
    rows keep their ring slot bit for bit."""
    theta = theta.float()
    new_mean, new_sq = fn(mean, sq, theta, n, mask, None, None, out_mean,
                          out_sq)
    if dev is not None:
        rows = torch.arange(mean.shape[0], device=mean.device)
        idx = slot.long()
        deviation = (theta - new_mean).to(dev.dtype)
        if mask is not None:
            live = (mask > 0).reshape((-1,) + (1,) * (mean.dim() - 1))
            deviation = torch.where(live, deviation, dev[rows, idx])
        dev[rows, idx] = deviation
    return new_mean, new_sq
