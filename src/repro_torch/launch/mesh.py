"""Device meshes for the particle axis (counterpart of
``repro.launch.mesh``).

One process drives every device, as the reference does: a ``Mesh`` is a
plain record of axis names, axis sizes and the ``torch.device`` at each
position, in mesh order. There is no communicator: the store keeps one
shard of each stacked tree per position (``core.store``), programs run
per position (``runtime.program.ShardedProgram``) and a gather is a copy
between two programs.

A ``devices=`` list may name one device several times: each entry is a
position of its own. That is the counterpart of the reference's forced
host devices (``--xla_force_host_platform_device_count``): the CPU tests
and a one-card machine run a 4-position mesh on logical positions of one
device. With no list the mesh spans ``cuda:0 .. cuda:{count-1}``.

Every factory validates the axis sizes against the devices up front and
raises a ``ValueError`` with the reference's wording.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """``axis_names`` in order, ``shape`` axis -> size, and ``devices``:
    an ndarray of ``torch.device`` of that shape, in mesh order."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: np.ndarray

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self):
        """The devices position by position (row-major)."""
        return list(self.devices.flat)


def _visible(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _validate(shape, axes, have: int) -> None:
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh shape {tuple(shape)} and axes {tuple(axes)} disagree: "
            f"{len(shape)} sizes for {len(axes)} axis names")
    if any(int(s) <= 0 for s in shape):
        raise ValueError(f"mesh shape {tuple(shape)} has a non-positive "
                         "axis size")
    want = math.prod(int(s) for s in shape)
    if want > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {want} devices but only "
            f"{have} are visible (pass devices= with a device repeated to "
            "emulate, or shrink an axis)")
    if have % want != 0:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} covers {want} of {have} visible "
            f"devices; {have} is not a multiple of {want}, so no axis size "
            "can be grown to use them all — pick axis sizes whose product "
            f"divides {have}")


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: the first prod(shape) of
    ``devices`` (default: every visible CUDA device), in order."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    pool = _visible(devices)
    _validate(shape, axes, len(pool))
    grid = np.empty(len(pool), dtype=object)
    for i, d in enumerate(pool):
        grid[i] = d
    grid = grid[:math.prod(shape)].reshape(shape)
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)), devices=grid)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's production mesh: data 16 x model 16 (one pod of
    256 positions), or pod 2 x data 16 x model 16 (``multi_pod``). With no
    ``devices`` its positions are the dry run's (``launch.steps.
    trace_devices``): fake positions that need no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        from .steps import trace_devices
        devices = trace_devices(math.prod(shape))
    return make_mesh(shape, axes, devices)


def make_bench_mesh(n_devices: int, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """2D ``(data=particle, model)`` mesh over ``n_devices`` positions.
    ``model`` must divide the device count; the particle axis gets the
    rest."""
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    if n_devices % model != 0:
        raise ValueError(
            f"model axis size {model} does not divide the device count "
            f"{n_devices}: the particle axis would get {n_devices}/{model} "
            "devices — pick a model-axis size that divides the device count")
    return make_mesh((n_devices // model, model), ("data", "model"), devices)


def pick_model_axis(params_bytes: int, n_devices: int, *,
                    device_memory_bytes: Optional[int] = None,
                    fraction: float = 0.6) -> int:
    """Smallest model-axis size (a divisor of ``n_devices``) whose shard
    of one particle's parameters, ``params_bytes / model``, fits within
    ``fraction`` of a device's memory. The budget is
    ``torch.cuda.mem_get_info()``'s total when ``device_memory_bytes`` is
    None; with no CUDA device (no budget) or unknown ``params_bytes`` it
    returns 1; when even ``model = n_devices`` does not fit, it returns
    ``n_devices``."""
    if device_memory_bytes is None and torch.cuda.is_available():
        device_memory_bytes = torch.cuda.mem_get_info()[1]
    if not device_memory_bytes or not params_bytes or n_devices <= 1:
        return 1
    budget = fraction * device_memory_bytes
    for m in (d for d in range(1, n_devices + 1) if n_devices % d == 0):
        if params_bytes / m <= budget:
            return m
    return n_devices
