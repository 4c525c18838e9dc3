"""Seeded synthetic data and the batched host loader (numpy only)."""
from .loader import DataLoader
from .synthetic import (advection_batch, frontend_stub, lm_batch, make_batch,
                        mnist_like)

__all__ = ["DataLoader", "advection_batch", "frontend_stub", "lm_batch",
           "make_batch", "mnist_like"]
