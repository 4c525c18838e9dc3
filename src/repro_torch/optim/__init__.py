"""Functional optimizers and learning-rate schedules over tensor trees."""
from .optimizers import Optimizer, adafactor, adam, sgd
from .optimizers import make as make_optimizer
from .schedules import constant, cosine, warmup_cosine

__all__ = ["Optimizer", "adafactor", "adam", "constant", "cosine",
           "make_optimizer", "sgd", "warmup_cosine"]
