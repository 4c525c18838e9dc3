"""Seeded synthetic data and the batched host loader (numpy only)."""
from .loader import DataLoader
from .synthetic import make_batch, mnist_like

__all__ = ["DataLoader", "make_batch", "mnist_like"]
