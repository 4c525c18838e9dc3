"""Layer-stacked transformer (counterpart of ``repro.models.transformer``):
the paged decode path of the LM and the full-sequence training layer of
the encoder stack (``enc_attn_mlp``, the ViT's layers).

The stack is ``cfg.head_layers + cfg.pattern * cfg.n_units +
cfg.tail_layers``. Repeated pattern units keep the reference's storage:
params and pages stacked on an ``n_units`` axis, which in the port sits
right after the particle axis (``(P, n_units, ...)``). The reference scans
over units; here a Python loop indexes each unit's params and pages as
views, so the in-place page writes land in the stacked pool. The
training path unbinds each unit leaf once (``unbind_units``: ``unbind``
backpropagates as one stack, where per-unit indexing would add a
full-size zero gradient per unit).
"""
from __future__ import annotations

from typing import Any, Dict

from ..core.tree import tree_map
from .blocks import (attn_apply_fullseq, attn_apply_paged,
                     attn_apply_prefill_paged, attn_init, attn_pages_init,
                     mlp_apply, mlp_init, norm_apply, norm_init)

PAGED_KINDS = ("attn_mlp",)
FULL_KINDS = {"attn_mlp": "causal", "enc_attn_mlp": "bidir"}


def layer_init(kind: str, gen, cfg, lead=()):
    if kind not in FULL_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    dev = gen.device
    return {"ln1": norm_init(cfg.norm, cfg.d_model, device=dev, lead=lead),
            "attn": attn_init(gen, cfg, lead=lead),
            "ln2": norm_init(cfg.norm, cfg.d_model, device=dev, lead=lead),
            "mlp": mlp_init(gen, cfg, lead=lead)}


def stack_init(gen, cfg) -> Dict[str, Any]:
    """One particle's stack params; unit leaves lead with n_units."""
    return {
        "head": tuple(layer_init(k, gen, cfg) for k in cfg.head_layers),
        "tail": tuple(layer_init(k, gen, cfg) for k in cfg.tail_layers),
        "units": tuple(layer_init(k, gen, cfg, lead=(cfg.n_units,))
                       for k in cfg.pattern),
    }


def unbind_units(tree):
    """A (P, n_units, ...) stacked unit tree -> one tree of (P, ...) views
    per unit, through one ``unbind(1)`` per leaf."""
    if isinstance(tree, dict):
        per = {k: unbind_units(v) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(_n(per))]
    if isinstance(tree, (tuple, list)):
        per = [unbind_units(t) for t in tree]
        return [type(tree)(p[i] for p in per) for i in range(_n(per))]
    return list(tree.unbind(1))


def _n(per):
    return len(next(iter(per.values())) if isinstance(per, dict) else per[0])


def layer_apply_full(kind: str, p, x, cfg):
    """One pre-norm attention + MLP layer over a whole sequence.
    x (P, B, S, D) -> (P, B, S, D)."""
    x = x + attn_apply_fullseq(p["attn"], norm_apply(p["ln1"], x), cfg,
                               kind=FULL_KINDS[kind])
    return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg)


def paged_guard(cfg):
    kinds = tuple(cfg.head_layers) + tuple(cfg.pattern) + tuple(cfg.tail_layers)
    bad = sorted({k for k in kinds if k not in PAGED_KINDS})
    if bad:
        raise NotImplementedError(
            f"paged decode supports {PAGED_KINDS} stacks only, got {bad}")
    if cfg.prefix_lm:
        raise NotImplementedError("paged decode does not support prefix_lm")


def _layer_apply_paged(kind, p, x, cfg, pages, ctx):
    h, pages = attn_apply_paged(
        p["attn"], norm_apply(p["ln1"], x), cfg, pages,
        block_tables=ctx["block_tables"], seq_lens=ctx["seq_lens"],
        write_index=ctx.get("write_index"),
        use_kernel=ctx.get("decode_kernel", True))
    x = x + h
    return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg), pages


def _layer_apply_prefill_paged(kind, p, x, cfg, pages, ctx):
    h, pages = attn_apply_prefill_paged(
        p["attn"], norm_apply(p["ln1"], x), cfg, pages,
        block_table_row=ctx["block_table_row"], n_tokens=ctx["n_tokens"])
    x = x + h
    return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg), pages


def _stack_apply_paged_common(params, x, cfg, pages, ctx, layer_fn):
    dt = x.dtype
    for kind, p, pg in zip(cfg.head_layers, params["head"], pages["head"]):
        x, _ = layer_fn(kind, p, x, cfg, pg, ctx)
    for u in range(cfg.n_units):
        for j, kind in enumerate(cfg.pattern):
            p = tree_map(lambda a: a[:, u], params["units"][j])
            pg = tree_map(lambda a: a[:, u], pages["units"][j])
            x, _ = layer_fn(kind, p, x, cfg, pg, ctx)
            x = x.to(dt)
    for kind, p, pg in zip(cfg.tail_layers, params["tail"], pages["tail"]):
        x, _ = layer_fn(kind, p, x, cfg, pg, ctx)
    return x, pages


def stack_apply_paged(params, x, cfg, pages, ctx):
    """One decode step over the paged pool. x (P, B, 1, D); ctx:
    block_tables (B, n_pmax), seq_lens (B,), optional write_index.
    Returns (x, pages) — the same page tensors, updated in place."""
    return _stack_apply_paged_common(params, x, cfg, pages, ctx,
                                     _layer_apply_paged)


def stack_apply_prefill_paged(params, x, cfg, pages, ctx):
    """Prompt prefill for one sequence into the pool. x (P, 1, Sp, D);
    ctx: block_table_row (n_pmax,), n_tokens int. Returns (x, pages)."""
    return _stack_apply_paged_common(params, x, cfg, pages, ctx,
                                     _layer_apply_prefill_paged)


def stack_paged_init(cfg, num_pages: int, page_size: int, *, dtype, device):
    """One particle's page pool: per attention layer a k/v pair of
    (num_pages, page_size, KVH, hd); unit layers stacked on n_units."""
    paged_guard(cfg)

    def one(lead=()):
        return attn_pages_init(cfg, num_pages, page_size, dtype=dtype,
                               device=device, lead=lead)

    return {"head": tuple(one() for _ in cfg.head_layers),
            "units": tuple(one((cfg.n_units,)) for _ in cfg.pattern),
            "tail": tuple(one() for _ in cfg.tail_layers)}
