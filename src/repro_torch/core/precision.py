"""Precision policy for particle ensembles (counterpart of
``repro.core.precision``), cut to what the paged serving path reads: the
fp32 preset and the KV-page storage dtype. The mixed/bf16/int8 rungs of
the reference's ladder wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class Precision:
    """Master and KV-page dtypes of one particle ensemble."""

    master_dtype: str = "float32"
    kv_dtype: Optional[str] = None     # None -> the model's cache default

    def __post_init__(self):
        if self.master_dtype != "float32":
            raise NotImplementedError("the port stores fp32 masters only")
        if self.kv_dtype is not None:
            _torch_dtype(self.kv_dtype)

    @property
    def master(self) -> torch.dtype:
        return _torch_dtype(self.master_dtype)

    @property
    def kv(self) -> Optional[torch.dtype]:
        return None if self.kv_dtype is None else _torch_dtype(self.kv_dtype)


PRESETS = {"fp32": Precision()}


def get(p: Any = None) -> Precision:
    """Resolve ``None`` | preset name | ``Precision`` to a ``Precision``."""
    if p is None:
        return PRESETS["fp32"]
    if isinstance(p, Precision):
        return p
    if isinstance(p, str):
        try:
            return PRESETS[p]
        except KeyError:
            raise ValueError(f"unknown or not yet ported precision preset "
                             f"{p!r}; options: {sorted(PRESETS)}") from None
    raise TypeError(f"precision must be None, str or Precision, got {type(p)}")
