"""Predictive heads computed on the device inside the serving step
(counterpart of ``repro.serve.uncertainty``).

For classification (member outputs = logits (P, B, C)), with the store's
(P,) active mask weighting live slots only:

  mean            BMA predictive distribution p̄ = mean over live i of softmax(z_i)
  entropy         H[p̄]                       — total predictive uncertainty
  expected_entropy mean over live i of H[p_i] — aleatoric part
  mutual_info     H[p̄] − E_i H[p_i]          — epistemic part (BALD)
  variance        mean_c Var_i[p_i(c)]       — particle disagreement

For regression (member outputs = point predictions (P, B, ...)):

  mean / variance  moments of the particle mixture (epistemic)
  entropy          Gaussian-approx 1/2 log(2 pi e sigma^2), averaged
                   over outputs
  mutual_info      = variance averaged over outputs

``bma_mean_probs``, ``expected_entropy``, ``mutual_information`` and
``particle_variance`` are the classification heads as standalone
functions over every member (no mask).
"""
from __future__ import annotations

import math

import torch

EPS = 1e-12

KINDS = ("classify", "regress")


def bma_mean_probs(member_logits):
    """(P, B, C) logits -> (B, C) BMA predictive probabilities."""
    return torch.softmax(member_logits.float(), dim=-1).mean(0)


def predictive_entropy(mean_probs):
    """H[p̄] in nats, (B, C) -> (B,)."""
    return -(mean_probs * torch.log(mean_probs + EPS)).sum(-1)


def expected_entropy(member_logits):
    """(1/P) Σ_i H[p_i] in nats, (P, B, C) -> (B,)."""
    logp = torch.log_softmax(member_logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(-1).mean(0)


def mutual_information(member_logits):
    """BALD score H[p̄] − E_i H[p_i], (P, B, C) -> (B,). Clamped >= 0
    (float cancellation can push the difference slightly negative)."""
    mi = (predictive_entropy(bma_mean_probs(member_logits))
          - expected_entropy(member_logits))
    return mi.clamp(min=0.0)


def particle_variance(member_probs):
    """Mean over classes of the across-particle variance, (P, B, C) ->
    (B,) (population variance, as ``jnp.var``)."""
    return member_probs.var(0, unbiased=False).mean(-1)


def _mask_stats(x, mask):
    """Mean/variance over the leading particle axis restricted to live
    slots. Dead rows are zeroed with ``where`` (NaN in a padding slot can
    never leak); the divisor is the live count."""
    m = mask.reshape(mask.shape[0], *([1] * (x.dim() - 1))) > 0
    live = mask.float().sum().clamp(min=1.0)
    mean = torch.where(m, x, 0.0).sum(0) / live
    var = torch.where(m, (x - mean) ** 2, 0.0).sum(0) / live
    return mean, var


def predictive_heads(member_outputs, kind: str = "classify", mask=None):
    """All heads from one stacked member-output tensor (P, B, C); returns
    a dict of tensors with leading batch axis B. ``mask`` is the store's
    (P,) active mask (None = every member live)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    x = member_outputs.float()
    if mask is None:
        mask = torch.ones(x.shape[0], device=x.device)
    if kind == "regress":
        mean, var = _mask_stats(x, mask)
        var_scalar = var.mean(dim=tuple(range(1, var.dim()))) \
            if var.dim() > 1 else var
        ent = 0.5 * torch.log(2.0 * math.pi * math.e * (var_scalar + EPS))
        return {"mean": mean, "variance": var, "entropy": ent,
                "expected_entropy": torch.zeros_like(ent),
                "mutual_info": var_scalar}
    probs = torch.softmax(x, dim=-1)                  # (P, B, C)
    logp = torch.log_softmax(x, dim=-1)
    member_ent = -(probs * logp).sum(-1)              # (P, B)
    mean, pvar = _mask_stats(probs, mask)
    exp_ent, _ = _mask_stats(member_ent, mask)
    ent = predictive_entropy(mean)
    return {
        "mean": mean,
        "variance": pvar.mean(-1),
        "entropy": ent,
        "expected_entropy": exp_ent,
        "mutual_info": (ent - exp_ent).clamp(min=0.0),
    }
