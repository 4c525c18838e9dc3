"""Functional optimizers over tensor trees."""
from .optimizers import Optimizer, adam, sgd

__all__ = ["Optimizer", "adam", "sgd"]
