"""SVGD's all-to-all: the CUDA kernels' wrappers (``csrc/svgd_rbf.cu``).

The kernels replace the Pallas TPU kernels ``repro.kernels.svgd_rbf``
``pairwise_sqdist`` and ``svgd_force`` and take the store's (n,) row mask
the reference's fused path passes (its Pallas kernels are dense-only):

    pairwise_sqdist(theta, mask=None)                       -> (n, n)
    svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None, *, out=None)
                                                            -> (n, D)

    theta, grads (n, D) fp32 contiguous; mask (n,) fp32 or None, a dead
    row (mask <= 0) read as zeros and, in the force, written as zeros;
    ktn (n, n) = K^T / n_eff; ksum (n,) = K.sum(0) / n_eff; inv_ell2 a
    one-element fp32 tensor (read on the device: no host sync); ``out``
    an (n, D) fp32 tensor that receives phi (it may not be theta or
    grads), a new one when None.

The wrappers take CUDA tensors only and raise on anything else; the CPU
goes through ``kernels.ops`` to the plain versions in ``kernels.ref``.
``<wrapper>.launches`` counts the wrapper's launches in this process (one
per call; ``pairwise_sqdist``'s second, reducing kernel is part of it).

``sqdist_plan`` is ``pairwise_sqdist``'s launch, fixed on the host from
the shapes and the SM count alone (never from the mask, which stays on
the device): its tile pairs, column chunks, one-wave grid, the ring's
shape and the path, ``"bulk"`` (rows copied with cp.async.bulk, which
needs 16-byte aligned rows: D % 4 == 0) or ``"plain"`` (plain loads).
``force_plan`` is ``svgd_force``'s launch, fixed the same way: the row
tiles, the column tiles each block walks (one persistent wave on the
vector path, one tile a block on the scalar path) and the path,
``"vector"`` (128-bit loads: D % 4 == 0 and theta, grads and phi 16-byte
aligned) or ``"scalar"``. ``svgd_force_columns`` launches the column
kernel (the first design: one thread a column, 8-row tiles) on the same
arguments: a probe of the streamed kernel, never on a path (it counts
its launches apart).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..obs import device as _obs
from .build import address, check, entry, is_fake, raise_on
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
_FORCE_ARGS = [_P] * 7 + [_I, _L] + [_I] * 3 + [_P]
_FORCE_COLUMNS_ARGS = [_P] * 7 + [_I, _L, _P]


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


@dataclass(frozen=True)
class ForcePlan:
    """One ``svgd_force`` launch (module docstring; csrc/svgd_rbf.cu
    force_stream_kernel). ``rows`` receiving rows a block: all n for
    n <= 8, else tiles of 8 (``row_tiles`` of them). A thread takes
    ``cols`` columns of a column tile of ``tile_cols`` (``columns``), and
    block ``b`` of ``grid`` (a multiple of ``row_tiles``) takes row tile
    ``b % row_tiles`` over the column tiles ``tiles(b)``."""
    n: int
    D: int
    path: str
    rows: int
    row_tiles: int
    cols: int
    tile_cols: int
    ntiles: int
    grid: int
    blocks_per_sm: int

    def row_tile(self, b: int) -> range:
        r = b % self.row_tiles
        return range(r * self.rows, min(self.n, (r + 1) * self.rows))

    def tiles(self, b: int) -> range:
        return range(b // self.row_tiles, self.ntiles,
                     self.grid // self.row_tiles)

    def columns(self, tile: int, thread: int):
        """The columns < D thread ``thread`` of a block computes in column
        tile ``tile``: float4 groups on the vector path, one column a
        step of the block's width on the scalar path."""
        c0 = tile * self.tile_cols
        if self.path == "vector":
            cols = [c0 + (q * _THREADS + thread) * 4 + e
                    for q in range(self.cols // 4) for e in range(4)]
        else:
            cols = [c0 + q * _THREADS + thread for q in range(self.cols)]
        return [c for c in cols if c < self.D]


@functools.lru_cache(maxsize=256)
def force_plan(n: int, D: int, sms: int, aligned: bool = True) -> ForcePlan:
    """The launch of ``svgd_force`` over (n, D) on ``sms`` SMs (mirrors
    csrc/svgd_rbf.cu force_cols / force_blocks). The vector path, when
    ``aligned`` (theta, grads and phi 16-byte aligned) and D % 4 == 0:
    ``cols`` 8 at n <= 2 and 4 above, 4 blocks an SM at n <= 4 and 2
    above, one wave of blocks (a whole number of row tiles, at least one
    of each). The scalar path: ``cols`` 4 at n <= 4 and 2 above, 4 blocks
    an SM, one column tile a block (the block scheduler balances the
    small tiles of a small D better than a fixed stride: the UNet's
    shape)."""
    if n < 1 or D < 1:
        raise ValueError("force_plan needs n >= 1 and D >= 1")
    vec = aligned and D % 4 == 0
    rows = n if n <= _TILE else _TILE
    row_tiles = -(-n // rows)
    if vec:
        cols, per_sm = (8 if n <= 2 else 4), (4 if n <= 4 else 2)
    else:
        cols, per_sm = (4 if n <= 4 else 2), 4
    tile_cols = _THREADS * cols
    ntiles = -(-D // tile_cols)
    wave = max(sms * per_sm // row_tiles, 1) if vec else ntiles
    return ForcePlan(n=n, D=D, path="vector" if vec else "scalar", rows=rows,
                     row_tiles=row_tiles, cols=cols, tile_cols=tile_cols,
                     ntiles=ntiles, grid=min(ntiles, wave) * row_tiles,
                     blocks_per_sm=per_sm)


def force_plan_for(theta, grads, out) -> ForcePlan:
    """The plan ``svgd_force(theta, grads, ..., out=out)`` launches with."""
    n, D = theta.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (theta, grads, out))
    return force_plan(n, D, sm_count(theta.device), aligned)


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
    if is_fake(theta):                   # the fake form (kernels.build)
        if not reduce:
            raise ValueError("reduce=False probes the card's first stage: "
                             "it has no fake form")
        if _obs.counting_now():
            _obs.charge(*sqdist_cost(theta), device=theta.device)
        return out
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
        _obs.charge(*sqdist_cost(theta), device=theta.device)
    return out if reduce else partial


def _force_args(theta, grads, ktn, ksum, inv_ell2, mask, out):
    """Check the force's arguments; returns phi's tensor (``out`` or a
    new one)."""
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
    if out is None:
        return torch.empty_like(theta)
    check("out", out, dev, (n, D))
    if out.numel() and address(out) in (address(theta), address(grads)):
        raise ValueError("out may not be theta or grads")
    return out


def svgd_force(theta, grads, ktn, ksum, inv_ell2, mask=None, *, out=None):
    """phi (n, D): the SVGD descent direction (module docstring), written
    into ``out`` when given."""
    out = _force_args(theta, grads, ktn, ksum, inv_ell2, mask, out)
    if out.numel() == 0:
        return out
    if is_fake(theta):                   # the fake form (kernels.build)
        if _obs.counting_now():
            _obs.charge(*force_cost(theta), device=theta.device)
        return out
    n, D = theta.shape
    plan = force_plan_for(theta, grads, out)
    with torch.cuda.device(theta.device):
        rc = entry("svgd_rbf", "svgd_force", _FORCE_ARGS)(
            theta.data_ptr(), grads.data_ptr(), ktn.data_ptr(),
            ksum.data_ptr(), inv_ell2.data_ptr(), _ptr(mask), out.data_ptr(),
            n, D, plan.grid, plan.cols, int(plan.path == "vector"),
            _stream(theta.device))
    raise_on(rc, "svgd_force")
    svgd_force.launches += 1
    if _obs.counting_now():
        _obs.charge(*force_cost(theta), device=theta.device)
    return out


def svgd_force_columns(theta, grads, ktn, ksum, inv_ell2, mask=None, *,
                       out=None):
    """``svgd_force`` through the column kernel (one thread a column,
    8-row tiles): a probe that the streamed kernel gives the same bits,
    and of its time. Never on a path; ``svgd_force_columns.launches`` counts apart."""
    out = _force_args(theta, grads, ktn, ksum, inv_ell2, mask, out)
    if out.numel() == 0:
        return out
    n, D = theta.shape
    with torch.cuda.device(theta.device):
        rc = entry("svgd_rbf", "svgd_force_columns", _FORCE_COLUMNS_ARGS)(
            theta.data_ptr(), grads.data_ptr(), ktn.data_ptr(),
            ksum.data_ptr(), inv_ell2.data_ptr(), _ptr(mask), out.data_ptr(),
            n, D, _stream(theta.device))
    raise_on(rc, "svgd_force_columns")
    svgd_force_columns.launches += 1
    return out


pairwise_sqdist.launches = 0
svgd_force.launches = 0
svgd_force_columns.launches = 0


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
