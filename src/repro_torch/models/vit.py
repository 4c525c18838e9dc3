"""Small Vision Transformer — the paper's Fig. 4 workload (counterpart of
``repro.models.vit``).

Patch-embeds 28x28 images (patch 14 -> 4 patches), prepends a CLS token,
adds learned positions, runs ``enc_attn_mlp`` layers (bidirectional
attention) and classifies from CLS. ``vit_init`` builds one particle;
``vit_apply`` takes the stacked tree (leading particle axis P) and one
image batch that every particle sees.
"""
from __future__ import annotations

import torch

from .blocks import dense_apply, dense_init, norm_apply, norm_init
from .transformer import layer_apply_full, layer_init, unbind_units

PATCH = 14
IMG = 28


def vit_init(gen, cfg):
    """One particle's params, drawn from ``gen`` on ``gen.device``; the
    key paths and shapes of the reference's ``vit_init``."""
    n_patch = (IMG // PATCH) ** 2
    dev = gen.device
    return {
        "patch": dense_init(gen, PATCH * PATCH, cfg.d_model),
        "cls": torch.randn((1, 1, cfg.d_model), generator=gen,
                           device=dev) * 0.02,
        "pos": torch.randn((1, n_patch + 1, cfg.d_model), generator=gen,
                           device=dev) * 0.02,
        "units": layer_init("enc_attn_mlp", gen, cfg, lead=(cfg.n_units,)),
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_size),
    }


def vit_apply(params, images, cfg, encoder=None):
    """images (B, 28, 28, 1) -> logits (P, B, n_classes). ``encoder(x)``
    runs the encoder layers on the embedded patches (default: this tree's
    units in turn; ``models.tp`` runs them over a model group)."""
    P = params["pos"].shape[0]
    B = images.shape[0]
    g = IMG // PATCH
    x = images.reshape(B, g, PATCH, g, PATCH)
    x = x.permute(0, 1, 3, 2, 4).reshape(B, g * g, PATCH * PATCH)
    x = dense_apply(params["patch"], x.expand(P, *x.shape))    # (P, B, 4, D)
    cls = params["cls"].to(x.dtype).expand(P, B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=2) + params["pos"].to(x.dtype)
    if encoder is None:
        # a Python loop over the stacked units takes the place of lax.scan
        for unit in unbind_units(params["units"]):
            x, _ = layer_apply_full("enc_attn_mlp", unit, x, cfg)
    else:
        x = encoder(x)
    x = norm_apply(params["final_norm"], x)
    return dense_apply(params["head"], x[:, :, 0])
