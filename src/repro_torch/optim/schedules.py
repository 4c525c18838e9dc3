"""Learning-rate schedules (counterpart of ``repro.optim.schedules``):
callables of the optimizer's integer ``step``.

``step`` is 0-d for one particle and ``(P,)`` on the store's stacked
trees (``optim.optimizers``); a schedule returns a number or a tensor of
``step``'s shape, which the updates broadcast per row. The arithmetic is
on the device (``torch.clamp`` and ``torch.where``, never a Python
``if`` on a tensor), so a captured step reads the schedule with no host
sync.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: lr


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.float(), max=float(total_steps)) / total_steps
        return lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        s = step.float()
        # the cosine branch is evaluated at step - warmup < 0 too, as the
        # reference's jnp.where does, and masked there
        return torch.where(s < warmup, lr * s / max(warmup, 1),
                           cos(step - warmup))
    return f
