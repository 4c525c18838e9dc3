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

``sqdist_plan`` is ``pairwise_sqdist``'s launch, fixed on the host from
the shapes and the SM count alone (never from the mask, which stays on
the device): its tile pairs, column chunks, one-wave grid, the ring's
shape and the path, ``"bulk"`` (rows copied with cp.async.bulk, which
needs 16-byte aligned rows: D % 4 == 0) or ``"plain"`` (plain loads).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..obs import device as _obs
from .build import check, entry, raise_on
from .split_walk import sm_count

_TILE = 8                  # rows of a tile (csrc/svgd_rbf.cu kTile)
# the ring: 2 stages of ~16 KB a block, 2 blocks an SM (64 KB in flight an
# SM), the fastest of the shapes chip_smoke.py's probe times on an H100
# (PERF.md section 6); more bytes in flight were slower there
_STAGES = 2
_STAGE_BYTES = 16 * 1024
_BLOCKS_PER_SM = 2         # __launch_bounds__(256, 2): at most 128 registers
_MAX_STAGES = 4            # csrc/svgd_rbf.cu kMaxStages
_THREADS = 256
_SM_SMEM = 233_472         # shared memory of a Hopper SM, in bytes
_BLOCK_SMEM_RESERVED = 1024  # the runtime's own, per block
_STATIC_SMEM = 8 * 64 * 4 + 8 * _MAX_STAGES  # the block reduction, barriers
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SQDIST_ARGS = [_P] * 4 + [_I, _L] + [_I] * 8 + [_P]
_FORCE_ARGS = [_P] * 7 + [_I, _L, _P]


@dataclass(frozen=True)
class SqdistPlan:
    """One ``pairwise_sqdist`` launch (module docstring).

    ``pairs`` are the tile pairs (ti, tj), ti <= tj, that hold a pair
    i < j; item ``p * nchunks + c`` is pair ``p`` over column chunk ``c``
    (``chunk(c)``), and block ``b`` of ``grid`` takes the items ``b, b +
    grid, ...`` (``items(b)``). A stage of the ring holds ``stage_rows``
    rows of ``tile_cols`` floats (bulk path; ``smem`` bytes of dynamic
    shared memory a block, ``blocks_per_sm`` blocks an SM)."""
    n: int
    D: int
    path: str
    pairs: tuple
    nchunks: int
    grid: int
    unit: int
    stages: int
    tile_cols: int
    stage_rows: int
    smem: int
    blocks_per_sm: int

    def chunk(self, c: int):
        """Columns [start, end) of chunk c: near-equal, contiguous, their
        bounds multiples of ``unit`` (4 floats, 16 bytes, on the bulk
        path)."""
        units = self.D // self.unit
        return (c * units // self.nchunks * self.unit,
                (c + 1) * units // self.nchunks * self.unit)

    def items(self, b: int):
        return range(b, len(self.pairs) * self.nchunks, self.grid)


@functools.lru_cache(maxsize=256)
def sqdist_plan(n: int, D: int, sms: int, *, stages: int = _STAGES,
                stage_bytes: int = _STAGE_BYTES,
                blocks_per_sm: int = _BLOCKS_PER_SM,
                base_aligned: bool = True) -> SqdistPlan:
    """The launch of ``pairwise_sqdist`` over (n, D) on ``sms`` SMs: one
    wave of blocks, as many column chunks per tile pair as fill it. The
    ring's shape (``stages``, ``stage_bytes``) and ``blocks_per_sm`` are
    the defaults above except in probes of the kernel's time."""
    if not 1 <= stages <= _MAX_STAGES:
        raise ValueError(f"stages must be in [1, {_MAX_STAGES}]")
    if not 1 <= blocks_per_sm <= _BLOCKS_PER_SM:
        raise ValueError(f"blocks_per_sm must be in [1, {_BLOCKS_PER_SM}]")
    tiles = -(-n // _TILE)
    pairs = tuple((ti, tj) for ti in range(tiles) for tj in range(ti, tiles)
                  if ti != tj or min(_TILE, n - ti * _TILE) > 1)
    bulk = D % 4 == 0 and base_aligned
    stage_rows = min(n, _TILE) if tiles <= 1 else 2 * _TILE
    tile_cols = max(_THREADS, stage_bytes // (4 * max(stage_rows, 1))
                    // _THREADS * _THREADS)
    smem = 4 * stages * stage_rows * tile_cols if bulk else 0
    per_sm = min(blocks_per_sm, _SM_SMEM // (smem + _STATIC_SMEM
                                             + _BLOCK_SMEM_RESERVED))
    if per_sm < 1:
        raise ValueError(f"a ring of {smem} bytes does not fit an SM")
    wave = sms * per_sm
    nchunks = 1
    if pairs:
        nchunks = max(1, min(wave // len(pairs), -(-D // tile_cols)))
    return SqdistPlan(n=n, D=D, path="bulk" if bulk else "plain",
                      pairs=pairs, nchunks=nchunks,
                      grid=min(len(pairs) * nchunks, wave),
                      unit=4 if bulk else 1, stages=stages,
                      tile_cols=tile_cols, stage_rows=stage_rows, smem=smem,
                      blocks_per_sm=per_sm)


def plan_for(theta, **ring) -> SqdistPlan:
    """The plan ``pairwise_sqdist(theta, **ring)`` launches with."""
    n, D = theta.shape
    return sqdist_plan(n, D, sm_count(theta.device),
                       base_aligned=theta.data_ptr() % 16 == 0, **ring)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def pairwise_sqdist(theta, mask=None, *, reduce: bool = True, **ring):
    """(n, D) -> (n, n) squared distances (shapes in the module docstring),
    exactly symmetric with an exact-zero diagonal. The other arguments are
    for probes of the kernel's time: ``ring`` (``stages``, ``stage_bytes``,
    ``blocks_per_sm``) reshapes the plan, and ``reduce=False`` launches the
    first stage alone and returns its (n, n, nchunks) partials (only the
    pairs i < j are written)."""
    if not isinstance(theta, torch.Tensor) or theta.dim() != 2:
        raise ValueError("theta must be an (n, D) tensor")
    n, D = theta.shape
    check("theta", theta, theta.device)
    if mask is not None:
        check("mask", mask, theta.device, (n,))
    out = torch.empty((n, n), dtype=torch.float32, device=theta.device)
    if n == 0 or D == 0:
        return out.zero_()
    plan = plan_for(theta, **ring)
    partial = torch.empty((n, n, plan.nchunks), dtype=torch.float32,
                          device=theta.device)
    with torch.cuda.device(theta.device):
        rc = entry("svgd_rbf", "svgd_pairwise_sqdist", _SQDIST_ARGS)(
            theta.data_ptr(), _ptr(mask), partial.data_ptr(), out.data_ptr(),
            n, D, len(plan.pairs), plan.nchunks, plan.grid, plan.stages,
            plan.tile_cols, plan.stage_rows, int(plan.path == "bulk"),
            int(reduce), _stream(theta.device))
    raise_on(rc, "pairwise_sqdist")
    pairwise_sqdist.launches += 1
    if _obs.counting_now():
        _obs.charge(*sqdist_cost(theta))
    return out if reduce else partial


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
    if _obs.counting_now():
        _obs.charge(*force_cost(theta))
    return out


pairwise_sqdist.launches = 0
svgd_force.launches = 0


def sqdist_cost(theta):
    """(FLOPs, bytes) of one ``pairwise_sqdist``: theta (n, D) read once,
    2 FLOPs a (pair, coordinate) over the n^2 pairs."""
    n, D = theta.shape
    return 2 * n * n * D, n * D * theta.element_size()


def force_cost(theta):
    """(FLOPs, bytes) of one ``svgd_force``: theta and the grads read and
    phi written once, 4 FLOPs a (pair, coordinate)."""
    n, D = theta.shape
    return 4 * n * n * D, 3 * n * D * theta.element_size()
