"""Model facade (counterpart of ``repro.models.api``): the dense LM's
paged continuous-batching entry points and the vision family's training
forward and loss.

``init_params`` builds ONE particle's tree (no particle axis); the store
stacks particles. Every other function takes the stacked tree with a
leading particle axis ``P`` and returns per-particle outputs ``(P, ...)``.
Batches carry no particle axis: every particle sees the same batch.

Vision batches: ``{"images": (B, 28, 28, 1) f32, "labels": (B,) int}``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .blocks import dense_init, norm_apply, norm_init, paged_write_index
from .transformer import (paged_guard, stack_apply_paged,
                          stack_apply_prefill_paged, stack_init,
                          stack_paged_init)
from . import vit as vit_mod


def init_params(gen, cfg):
    """One particle's params, drawn from ``gen`` on ``gen.device``."""
    if cfg.family == "vision":
        return vit_mod.vit_init(gen, cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=gen.device) * 0.02,
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=gen.device),
        **stack_init(gen, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
    return params


def forward(params, batch, cfg):
    """Training-style full forward. Returns (per-particle output, aux):
    logits (P, B, n_classes) for the vision family."""
    if cfg.family != "vision":
        raise NotImplementedError(f"family {cfg.family!r} has no ported "
                                  f"training forward")
    return vit_mod.vit_apply(params, batch["images"], cfg), {}


def loss_fn(params, batch, cfg):
    """Returns (loss (P,), metrics): class cross-entropy and accuracy,
    each averaged over the batch, one value per particle."""
    out, _ = forward(params, batch, cfg)
    logits = out.float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)                       # (P, B)
    gold = logits.gather(-1, labels.expand(logits.shape[:2])[..., None])
    loss = (lse - gold[..., 0]).mean(-1)
    acc = (logits.argmax(-1) == labels).float().mean(-1)
    return loss, {"loss": loss, "acc": acc}


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _cache_dtype(cfg):
    return torch.bfloat16 if _dtype(cfg) == torch.bfloat16 else torch.float32


def _embed(params, tokens, dtype):
    """tokens (B, S) -> (P, B, S, D)."""
    return params["embed"].to(dtype)[:, tokens.long()]


def _lm_logits(params, x, cfg):
    """x (P, ..., D) -> (P, ..., V); the tied head is x @ embed.T."""
    w = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
         else params["lm_head"]["w"]).to(x.dtype)
    P, D = x.shape[0], x.shape[-1]
    return torch.bmm(x.reshape(P, -1, D), w).reshape(*x.shape[:-1],
                                                     w.shape[-1])


def paged_cache_init(cfg, *, num_pages: int, page_size: int, dtype=None,
                     device=None):
    """One particle's KV page pool: a (num_pages, page_size, KVH, hd) k/v
    pair per attention layer. Block tables live with the scheduler."""
    return stack_paged_init(cfg, num_pages, page_size,
                            dtype=dtype or _cache_dtype(cfg),
                            device=torch.device("cuda") if device is None
                            else device)


def decode_step_paged(params, tokens, pages, block_tables, seq_lens, cfg, *,
                      decode_kernel: bool = True):
    """One continuous-batching decode step for every particle.

    tokens (B,) int (garbage ok on inactive rows); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32 absolute position of each token
    (-1 = inactive row: no pool writes, logits garbage — mask downstream).
    Pages are updated in place. Returns (logits (P, B, V), pages).
    ``decode_kernel=False`` takes the plain attention on any device, for
    parity checks against the kernel; ``serve_decode`` never sets it."""
    paged_guard(cfg)
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    x = _embed(params, tokens.clamp(min=0)[:, None], _dtype(cfg))
    ctx: Dict[str, Any] = {
        "block_tables": block_tables, "seq_lens": seq_lens,
        "write_index": paged_write_index(block_tables, seq_lens,
                                         _page_size(pages)),
        "decode_kernel": decode_kernel}
    x, pages = stack_apply_paged(params, x, cfg, pages, ctx)
    x = norm_apply(params["final_norm"], x)
    return _lm_logits(params, x, cfg)[:, :, 0], pages


def prefill_paged(params, tokens, pages, block_table_row, n_tokens, cfg):
    """Prompt prefill for ONE sequence into the page pool.

    tokens (1, Sp) int padded to a shape bucket; block_table_row
    (n_pmax,) int32; n_tokens: count of real tokens. Returns
    (last-real-token logits (P, 1, V), pages)."""
    paged_guard(cfg)
    n_tokens = int(n_tokens)
    x = _embed(params, tokens, _dtype(cfg))
    ctx: Dict[str, Any] = {"block_table_row": block_table_row,
                           "n_tokens": n_tokens}
    x, pages = stack_apply_prefill_paged(params, x, cfg, pages, ctx)
    x = norm_apply(params["final_norm"], x)
    last = x[:, :, max(n_tokens - 1, 0)]                    # (P, 1, D)
    return _lm_logits(params, last, cfg), pages


def _page_size(pages) -> int:
    for group in ("units", "head", "tail"):
        if pages[group]:
            return pages[group][0]["k"].shape[-3]
    raise ValueError("page tree holds no attention layer")
