"""Calibration metrics for served predictive distributions (counterpart
of ``repro.serve.metrics``).

Tensor implementations (usable on the device right after a BMA forward)
plus independent NumPy references (``*_ref``) that the tests check them
against — the references are written in the most literal textbook form,
no shared code with the tensor path.

  nll     mean −log p̄(y)                 (proper score; nats)
  brier   mean ‖p̄ − onehot(y)‖²          (quadratic proper score)
  ece     Σ_b (n_b/N) |acc(b) − conf(b)|  (expected calibration error,
          equal-width confidence bins over (0, 1])

Each tensor metric takes numpy arrays or tensors and returns a 0-d
tensor on the inputs' device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

EPS = 1e-12


def _tensors(probs, labels):
    probs = torch.as_tensor(probs)
    return probs, torch.as_tensor(labels, device=probs.device).long()


# ---------------------------------------------------------------------------
# tensor implementations (the serving path)
# ---------------------------------------------------------------------------

def nll(probs, labels):
    """probs: (B, C) predictive distribution; labels: (B,) ints -> scalar."""
    probs, labels = _tensors(probs, labels)
    p_gold = probs.gather(-1, labels[:, None])[:, 0]
    return -torch.log(p_gold + EPS).mean()


def brier(probs, labels):
    probs, labels = _tensors(probs, labels)
    onehot = torch.zeros_like(probs).scatter_(-1, labels[:, None], 1.0)
    return ((probs - onehot) ** 2).sum(-1).mean()


def accuracy(probs, labels):
    probs, labels = _tensors(probs, labels)
    return (probs.argmax(-1) == labels).to(torch.float32).mean()


def ece(probs, labels, n_bins: int = 15):
    """Equal-width confidence binning over (0, 1]; empty bins contribute 0."""
    probs, labels = _tensors(probs, labels)
    conf = probs.max(-1).values
    correct = (probs.argmax(-1) == labels).to(probs.dtype)
    # bin i covers (i/n, (i+1)/n]; conf == 0 is clamped into bin 0
    idx = (torch.ceil(conf * n_bins).long() - 1).clamp(0, n_bins - 1)
    zeros = probs.new_zeros(n_bins)
    n_b = zeros.index_add(0, idx, torch.ones_like(conf))
    conf_b = zeros.index_add(0, idx, conf)
    acc_b = zeros.index_add(0, idx, correct)
    gap = (acc_b - conf_b).abs()            # n_b * |acc(b) - conf(b)|
    return torch.where(n_b > 0, gap, 0.0).sum() / probs.shape[0]


def calibration_report(probs, labels, n_bins: int = 15) -> Dict[str, float]:
    """Host-side summary of every metric (one device sync)."""
    vals = torch.stack([nll(probs, labels), brier(probs, labels),
                        ece(probs, labels, n_bins),
                        accuracy(probs, labels).to(torch.as_tensor(
                            probs).dtype)]).tolist()
    return dict(zip(("nll", "brier", "ece", "accuracy"), vals))


# ---------------------------------------------------------------------------
# NumPy references (tests only — deliberately independent, literal forms)
# ---------------------------------------------------------------------------

def nll_ref(probs, labels) -> float:
    probs, labels = np.asarray(probs), np.asarray(labels)
    return float(np.mean([-np.log(probs[i, labels[i]] + EPS)
                          for i in range(len(labels))]))


def brier_ref(probs, labels) -> float:
    probs, labels = np.asarray(probs), np.asarray(labels)
    total = 0.0
    for i in range(len(labels)):
        onehot = np.zeros(probs.shape[1])
        onehot[labels[i]] = 1.0
        total += float(np.sum((probs[i] - onehot) ** 2))
    return total / len(labels)


def accuracy_ref(probs, labels) -> float:
    probs, labels = np.asarray(probs), np.asarray(labels)
    return float(np.mean(np.argmax(probs, axis=-1) == labels))


def ece_ref(probs, labels, n_bins: int = 15) -> float:
    probs, labels = np.asarray(probs), np.asarray(labels)
    conf = np.max(probs, axis=-1)
    pred = np.argmax(probs, axis=-1)
    total = 0.0
    for b in range(n_bins):
        lo, hi = b / n_bins, (b + 1) / n_bins
        sel = (conf > lo) & (conf <= hi) if b else (conf <= hi)
        if not np.any(sel):
            continue
        acc_b = float(np.mean(pred[sel] == labels[sel]))
        conf_b = float(np.mean(conf[sel]))
        total += (np.sum(sel) / len(labels)) * abs(acc_b - conf_b)
    return total
