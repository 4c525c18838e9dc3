"""Synthetic datasets (fully offline, seeded); numpy only.

A copy of ``repro.data.synthetic`` cut to the vision family, so the same
seed gives byte-identical batches in both packages:

  mnist_like : class-conditional blob images, 28x28x1, 10 classes — a
               stand-in for MNIST in the paper's ViT experiments.
"""
from __future__ import annotations

import numpy as np


def mnist_like(rng: np.random.Generator, batch: int, n_classes: int = 10):
    """Class-conditional blobs: class c -> bright blob at a c-specific spot."""
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    xs = np.zeros((batch, 28, 28, 1), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for i, c in enumerate(labels):
        cy, cx = 6 + 3 * (c % 4), 6 + 3 * (c // 4)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 12.0)
        xs[i, :, :, 0] = blob + 0.1 * rng.standard_normal((28, 28))
    return {"images": xs, "labels": labels}


def make_batch(cfg, rng: np.random.Generator, batch: int, seq: int):
    """Family-dispatching batch builder for a ModelConfig (vision only)."""
    if cfg.family == "vision":
        return mnist_like(rng, batch, cfg.vocab_size)
    raise NotImplementedError(f"family {cfg.family!r} has no ported data")
