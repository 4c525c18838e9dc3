"""SWAG moment passes: the CUDA kernels' wrappers (``csrc/swag_moments.cu``).

The kernels replace the Pallas TPU kernels ``repro.kernels.swag_moments``
``moments_flat`` and ``diag_std_flat``. They run over the store's stacked
rows leaf by leaf, every leaf of a tree in one launch (no flatten copy):

    moments(mean, sq, theta, n, mask=None, dev=None, slot=None,
            out_mean=None, out_sq=None)
        mean, sq, theta (P, ...) fp32 contiguous; n (P,) fp32 per row;
        mask (P,) fp32 or None -> (mean', sq'); a dead row is copied
        through bit for bit. With dev (P, R, ...) and slot (P,) int32 the
        live rows' deviations theta - mean' land in dev[p, slot[p]], in
        place. mean' and sq' are written into ``out_mean`` and ``out_sq``
        when given (new tensors otherwise); ``out_mean=mean, out_sq=sq``
        updates the moments in place.
    moments_leaves(means, sqs, thetas, n, mask=None, devs=None, slot=None)
        the same update over every leaf of a tree in place (lists of
        (P, ...) leaves; devs (P, R, ...) each, one R), one launch per
        ``MAX_LEAVES`` leaves: the collection's path (``bdl.swag``).
        Returns (means, sqs).
    diag_std_leaves(means, sqs) -> [sqrt(max(sq - mean^2, 1e-30)), ...]
        the diagonal scale of every leaf of a tree (lists of tensors of
        any shape), one launch per ``MAX_LEAVES`` non-empty leaves, into
        one flat buffer: a contiguous view a leaf, shaped like its mean.
        The sampling path's (``bdl.swag``): once per particle, not per
        draw.
    diag_std(mean, sq) -> sqrt(max(sq - mean^2, 1e-30)), any shape: one
        leaf, the first design, kept as a probe and the single-leaf entry.

The wrappers take CUDA tensors only and raise on anything else; the CPU
goes through ``kernels.ops`` to the plain versions in ``kernels.ref``.
``<wrapper>.launches`` counts the wrapper's launches in this process.

``leaves_plan`` is ``moments_leaves``' launches, fixed on the host from
the row count, the leaves' lengths and the SM count: the leaves of each
launch, the first work item of each leaf (a work item is one row's chunk
of ``CHUNK`` elements) and a one-wave grid; ``diag_std_leaves`` runs the
same plan at one row of each leaf's whole length. ``moments`` and
``diag_std`` (one leaf, the first designs) stay for probes and as the
per-leaf peers the one-launch kernels are held to.

The kernels are fp32 only. Under bf16 masters the SWAG moments stay fp32
and the params and the deviation ring are bf16 (``bdl.swag``);
``kernels.ops`` then runs the moments kernel (or its plain version) on
the params widened to fp32 through ``leaves_via_fp32`` (still one
launch), as the reference's ``update_moments`` widens its inputs, and
writes the ring there.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..obs import device as _obs
from .build import address, check, entry, is_fake, raise_on
from .split_walk import sm_count

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MOMENTS_ARGS = [_P] * 7 + [_I] + [_P] * 2 + [_I, _L, _P]
_LEAVES_ARGS = [_P] * 3 + [_I, _L] + [_P] * 3 + [_I] * 3 + [_P]
_DIAG_STD_ARGS = [_P] * 3 + [_L, _P]
_DIAG_LEAVES_ARGS = [_P] * 3 + [_I, _L, _I, _P]
_THREADS = 256
_GROUPS = 4                # float4 groups a thread an item (csrc kGroups)
CHUNK = _THREADS * 4 * _GROUPS   # elements a work item (csrc kChunk)
MAX_LEAVES = 64            # leaves a launch (csrc kMaxLeaves)
_LEAF_BYTES = 48           # csrc Leaf: four pointers, L, start
PARAM_BYTES = MAX_LEAVES * _LEAF_BYTES + 40   # csrc LeafSet, < 4 KB
_BLOCKS_PER_SM = 2         # csrc kLeafBlocks: __launch_bounds__(256, 2)


@dataclass(frozen=True)
class LeavesPlan:
    """``moments_leaves``' launches (module docstring): ``groups[k]`` the
    leaf indices of launch k, ``starts[k]`` their first work items (leaf
    by leaf, ``P * ceil(L / CHUNK)`` items a leaf), ``items[k]`` and
    ``grids[k]`` the launch's item count and blocks. Block ``b`` takes
    the items ``b, b + grid, ...``; ``item(k, i)`` is the (leaf, row,
    elements) of item ``i`` of launch ``k``."""
    P: int
    lengths: tuple
    groups: tuple
    starts: tuple
    items: tuple
    grids: tuple

    def item(self, k: int, i: int):
        group, starts = self.groups[k], self.starts[k]
        j = max(a for a in range(len(group)) if starts[a] <= i)
        L = self.lengths[group[j]]
        chunks = -(-L // CHUNK)
        p, c = divmod(i - starts[j], chunks)
        return group[j], p, range(c * CHUNK, min(L, (c + 1) * CHUNK))


@functools.lru_cache(maxsize=256)
def leaves_plan(P: int, lengths: tuple, sms: int) -> LeavesPlan:
    """The launches of ``moments_leaves`` over ``P`` rows of leaves of
    ``lengths`` elements a row on ``sms`` SMs: ``MAX_LEAVES`` leaves a
    launch, in order, each launch one wave of blocks (or fewer, one an
    item)."""
    if P < 1 or any(L < 1 for L in lengths):
        raise ValueError("leaves_plan needs P >= 1 and non-empty leaves")
    groups, starts, items, grids = [], [], [], []
    for lo in range(0, len(lengths), MAX_LEAVES):
        group = tuple(range(lo, min(lo + MAX_LEAVES, len(lengths))))
        at, st = 0, []
        for j in group:
            st.append(at)
            at += P * -(-lengths[j] // CHUNK)
        groups.append(group)
        starts.append(tuple(st))
        items.append(at)
        grids.append(min(at, sms * _BLOCKS_PER_SM))
    return LeavesPlan(P=P, lengths=tuple(lengths), groups=tuple(groups),
                      starts=tuple(starts), items=tuple(items),
                      grids=tuple(grids))


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


def _leaves_args(means, sqs, thetas, n, mask, devs, slot):
    """Check ``moments_leaves``' arguments in one pass over the leaves (a
    tree's collection checks a hundred tensors a call: the slow checks run
    only to name what is wrong). Returns (P, R, the indices of the
    non-empty leaves, their four pointers each, their lengths a row)."""
    if not means or not all(isinstance(m, torch.Tensor) and m.dim() >= 1
                            for m in means):
        raise ValueError("means must be a non-empty list of (P, ...) tensors")
    if not len(sqs) == len(thetas) == len(means) or (
            devs is not None and len(devs) != len(means)):
        raise ValueError("one sq, theta (and dev) per mean")
    device, P = means[0].device, means[0].shape[0]
    check("n", n, device, (P,))
    if mask is not None:
        check("mask", mask, device, (P,))
    if (devs is None) != (slot is None):
        raise ValueError("pass devs and slot together")
    R = 0
    if devs is not None:
        check("slot", slot, device, (P,), torch.int32)
        R = devs[0].shape[1] if devs[0].dim() >= 2 else 0
    live, ptrs, lens = [], [], []
    for i, (m, s, t) in enumerate(zip(means, sqs, thetas)):
        d = None if devs is None else devs[i]
        shape = m.shape
        xs = (m, s, t) if d is None else (m, s, t, d)
        ok = shape[0] == P and s.shape == shape and t.shape == shape and (
            d is None or (d.dim() == m.dim() + 1 and d.shape[:2] == (P, R)
                          and d.shape[2:] == shape[1:]))
        if not (ok and all(x.is_cuda and x.device == device
                           and x.dtype == torch.float32 and x.is_contiguous()
                           for x in xs)):
            if shape[0] != P:
                raise ValueError(f"leaf {i}: {shape[0]} rows, not {P}")
            for name, x in zip(("means", "sqs", "thetas", "devs"), xs):
                check(f"{name}[{i}]", x, device, tuple(shape) if name !=
                      "devs" else (P, R) + tuple(shape[1:]))
        pm, ps, pt = address(m), address(s), address(t)
        if pm == ps or pt in (pm, ps):
            raise ValueError(f"leaf {i}: mean, sq and theta must not alias")
        if m.numel():
            live.append(i)
            ptrs += (pm, ps, pt, 0 if d is None else address(d))
            lens.append(m.numel() // P)
    return P, R, live, ptrs, lens


def moments_leaves(means, sqs, thetas, n, mask=None, devs=None, slot=None):
    """One SWAG collection over every leaf, in place (module docstring):
    one launch per ``MAX_LEAVES`` leaves. Returns (means, sqs)."""
    P, R, live, ptrs, lens = _leaves_args(means, sqs, thetas, n, mask, devs,
                                         slot)
    if not live:
        return means, sqs
    device = means[0].device
    if is_fake(means[0]):                # the fake form (kernels.build)
        if _obs.counting_now():
            for i in live:
                _obs.charge(*moments_cost(
                    means[i], None if devs is None else devs[i]),
                    device=device)
        return means, sqs
    plan = leaves_plan(P, tuple(lens), sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = entry("swag_moments", "swag_moments_leaves", _LEAVES_ARGS)
    for group, starts, items, grid in zip(plan.groups, plan.starts,
                                          plan.items, plan.grids):
        lo, hi = group[0], group[-1] + 1       # a group is a run of leaves
        k = hi - lo
        with torch.cuda.device(device):
            rc = fn((ctypes.c_longlong * (4 * k))(*ptrs[4 * lo:4 * hi]),
                    (ctypes.c_longlong * k)(*lens[lo:hi]),
                    (ctypes.c_longlong * k)(*starts), k, items, n.data_ptr(),
                    _ptr(mask), _ptr(slot), R, P, grid, stream)
        raise_on(rc, "swag moments_leaves")
        moments_leaves.launches += 1
        if _obs.counting_now():
            for i in live[lo:hi]:
                _obs.charge(*moments_cost(
                    means[i], None if devs is None else devs[i]),
                    device=device)
    return means, sqs


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


def diag_layout(numels):
    """Where ``diag_std_leaves`` puts each leaf's scale in its one output
    buffer: (the offsets, the buffer's length). Every leaf starts on a
    16-byte boundary (a multiple of 4 floats), so an aligned leaf of a
    length divisible by 4 takes the kernel's 128-bit stores."""
    offsets, at = [], 0
    for L in numels:
        offsets.append(at)
        at += -(-L // 4) * 4
    return offsets, at


def _diag_leaves_args(means, sqs):
    """Check ``diag_std_leaves``' arguments in one pass over the leaves
    (the slow checks run only to name what is wrong; the pass is the
    wrapper's host time at a small tree). Returns (the device, every
    leaf's length, the indices of the non-empty leaves)."""
    if not means or not all(isinstance(m, torch.Tensor) for m in means):
        raise ValueError("means must be a non-empty list of tensors")
    if len(sqs) != len(means):
        raise ValueError("one sq per mean")
    device, index, f32 = means[0].device, means[0].get_device(), torch.float32
    numels, live = [], []
    for i, (m, s) in enumerate(zip(means, sqs)):
        if not (isinstance(s, torch.Tensor) and s.shape == m.shape
                and m.is_cuda and s.is_cuda and m.get_device() == index
                and s.get_device() == index and m.dtype is f32
                and s.dtype is f32 and m.is_contiguous()
                and s.is_contiguous()):
            check(f"means[{i}]", m, device)
            check(f"sqs[{i}]", s, device, tuple(m.shape))
        numels.append(m.numel())
        if numels[-1]:
            live.append(i)
    return device, numels, live


def diag_std_leaves(means, sqs):
    """The diagonal scale of every leaf (module docstring): one launch per
    ``MAX_LEAVES`` non-empty leaves. Returns a list of scales, each a
    contiguous view of one new buffer, shaped like its mean."""
    device, numels, live = _diag_leaves_args(means, sqs)
    offsets, total = diag_layout(numels)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    outs = [flat.as_strided(m.shape, m.stride(), o)
            for o, m in zip(offsets, means)]
    lens = [numels[i] for i in live]
    if not live:
        return outs
    if is_fake(means[0]):                # the fake form (kernels.build)
        if _obs.counting_now():
            for i in live:
                _obs.charge(*diag_std_cost(means[i]), device=device)
        return outs
    plan = leaves_plan(1, tuple(lens), sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = entry("swag_moments", "swag_diag_std_leaves", _DIAG_LEAVES_ARGS)
    for group, starts, items, grid in zip(plan.groups, plan.starts,
                                          plan.items, plan.grids):
        idx = live[group[0]:group[-1] + 1]     # a group is a run of leaves
        k = len(idx)
        ptrs = [p for i in idx for p in (means[i].data_ptr(),
                                         sqs[i].data_ptr(),
                                         outs[i].data_ptr())]
        with torch.cuda.device(device):
            rc = fn((ctypes.c_longlong * (3 * k))(*ptrs),
                    (ctypes.c_longlong * k)(*lens[group[0]:group[-1] + 1]),
                    (ctypes.c_longlong * k)(*starts), k, items, grid, stream)
        raise_on(rc, "swag diag_std_leaves")
        diag_std_leaves.launches += 1
        if _obs.counting_now():
            for i in idx:
                _obs.charge(*diag_std_cost(means[i]), device=device)
    return outs


moments.launches = 0
moments_leaves.launches = 0
diag_std_leaves.launches = 0
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


def leaves_via_fp32(fn, means, sqs, thetas, n, mask=None, devs=None,
                    slot=None):
    """``moments_leaves`` under bf16 masters: the moments are fp32
    (``bdl.swag.swag_state_init``), theta and the deviation ring are not.
    ``fn`` (the kernel or its plain version) runs once on every theta
    widened to fp32, and a live row's deviation lands in ``dev[p,
    slot[p]]`` here, as ``theta - mean'`` in fp32 cast to the ring's
    dtype (the reference's ``(p - m).astype(d.dtype)`` with its fp32
    moments); dead rows keep their ring slot bit for bit."""
    wide = [t.float() for t in thetas]
    fn(means, sqs, wide, n, mask)
    if devs is not None:
        rows = torch.arange(means[0].shape[0], device=means[0].device)
        idx = slot.long()
        for m, t, d in zip(means, wide, devs):
            deviation = (t - m).to(d.dtype)
            if mask is not None:
                live = (mask > 0).reshape((-1,) + (1,) * (m.dim() - 1))
                deviation = torch.where(live, deviation, d[rows, idx])
            d[rows, idx] = deviation
    return means, sqs
