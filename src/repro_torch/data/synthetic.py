"""Synthetic datasets (fully offline, seeded); numpy only.

A copy of ``repro.data.synthetic``, so the same seed gives
byte-identical batches in both packages:

  lm_batch        : Zipf-ish token stream with local n-gram structure so a
                    LM has signal to fit (loss visibly decreases).
  mnist_like      : class-conditional blob images, 28x28x1, 10 classes —
                    a stand-in for MNIST in the paper's ViT experiments.
  advection_batch : 1-D advection PDE u_t + c u_x = 0 pairs (u(t), u(t+dt))
                    with random smooth initial conditions — the paper's
                    PDEBench UNet task, 1-D.
  frames / patches: stub frontend embeddings for audio/vlm families.
"""
from __future__ import annotations

import numpy as np


_PERM_CACHE = {}


def lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
             noise_p: float = 0.1):
    """Markov token stream: next = perm[prev] with prob 1-noise_p, else
    uniform — a bigram-learnable signal (optimal CE ~= H(noise) ~ 1.1 nats
    at the default noise), seeded per vocab so every batch shares the map."""
    if vocab not in _PERM_CACHE:
        _PERM_CACHE[vocab] = np.random.default_rng(vocab).permutation(vocab)
    perm = _PERM_CACHE[vocab]
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    flip = rng.random((batch, seq)) < noise_p
    rand = rng.integers(0, vocab, (batch, seq))
    for t in range(seq):
        toks[:, t + 1] = np.where(flip[:, t], rand[:, t], perm[toks[:, t]])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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


def advection_batch(rng: np.random.Generator, batch: int, L: int = 128,
                    c: float = 1.0, dt: float = 4.0):
    """Periodic 1-D advection: u(x, t+dt) = u(x - c*dt, t) (exact shift)."""
    x = np.arange(L, dtype=np.float32)
    u0 = np.zeros((batch, L), np.float32)
    for k in range(1, 4):
        amp = rng.standard_normal((batch, 1)).astype(np.float32) / k
        phase = rng.uniform(0, 2 * np.pi, (batch, 1)).astype(np.float32)
        u0 += amp * np.sin(2 * np.pi * k * x[None] / L + phase)
    shift = int(round(c * dt)) % L
    u1 = np.roll(u0, shift, axis=1)
    return {"u0": u0[..., None], "u1": u1[..., None]}


def frontend_stub(rng: np.random.Generator, batch: int, length: int, d: int):
    """Precomputed frame/patch embeddings (audio conv stub / SigLIP stub)."""
    return rng.standard_normal((batch, length, d)).astype(np.float32) * 0.1


def make_batch(cfg, rng: np.random.Generator, batch: int, seq: int):
    """Family-dispatching batch builder for a ModelConfig: the LM families
    get ``lm_batch``, the audio family adds ``frames`` (batch, n_frames,
    d_model) and the vlm family ``patches`` (batch, n_prefix_tokens,
    d_model), drawn after the tokens from the same stream."""
    if cfg.family == "vision":
        return mnist_like(rng, batch, cfg.vocab_size)
    if cfg.family == "pde":
        return advection_batch(rng, batch, cfg.max_seq_len)
    out = lm_batch(rng, batch, seq, cfg.vocab_size)
    if cfg.family == "audio":
        out["frames"] = frontend_stub(rng, batch, cfg.n_frames, cfg.d_model)
    if cfg.family == "vlm":
        out["patches"] = frontend_stub(rng, batch, cfg.n_prefix_tokens,
                                       cfg.d_model)
    return out
