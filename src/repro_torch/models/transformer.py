"""Layer-stacked transformer (counterpart of ``repro.models.transformer``):
the LM's serving paths (paged decode, speculative verify window and
prefill over the page pool; prefill into and decode over a dense cache
or recurrent state), the LM's training stack (``stack_apply_full``,
with the remat menu) and the full-sequence training layer of the
encoder stack (``enc_attn_mlp``, the ViT's layers).

Layer kinds: ``attn_mlp`` (global attention + MLP), ``attn_moe`` (global
attention + the MoE of ``models.moe``), ``local`` (``attn_mlp`` with a
sliding window of ``cfg.sliding_window`` keys: a ring cache of that many
slots in dense-cache decode; no paged form, as in the reference),
``enc_attn_mlp`` (bidirectional: the encoders of the ViT and of
whisper), ``dec_attn_mlp`` (whisper's decoder layer: causal
self-attention, cross-attention over the encoder's output, MLP; its
dense cache holds the self-attention's k / v and the cross-attention's
encoder k / v, no paged form), ``mamba`` (``models.mamba``) and ``rwkv``
(``models.rwkv``), whose decode state is their scan's (no paged form
either), and ``shared_attn`` (zamba2's shared block: an ``attn_mlp``
layer whose one parameter copy, at ``params["shared"]``, serves every
occurrence in the pattern; its gradient sums over them, while each
occurrence keeps its own cache). Under ``cfg.prefix_lm`` (paligemma) the
attention layers take the prefix-LM mask: the first ``prefix_len``
positions are seen by every query. The layers that need more than x (the
encoder's output, the prefix length) read it from one ``ctx`` dict that
the stack functions hand to every layer, as the reference's do.

The stack is ``cfg.head_layers + cfg.pattern * cfg.n_units +
cfg.tail_layers``. Repeated pattern units keep the reference's storage:
params and pages stacked on an ``n_units`` axis, which in the port sits
right after the particle axis (``(P, n_units, ...)``; a ``shared_attn``
position holds ``{}``). The reference scans over units; here a Python
loop indexes each unit's params, pages and dense caches as views, so
the in-place writes land in the stacked pool, cache or state (a dense
cache's slot positions, shared by the particles, are stacked as
``(n_units, B, C)``; a recurrent state's leaves as ``(P, n_units, B,
...)``). The training path unbinds each unit leaf once (``unbind_units``:
``unbind`` backpropagates as one stack, where per-unit indexing would
add a full-size zero gradient per unit).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.precision import checkpoint_policy
from ..core.tree import tree_map
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .blocks import (attn_apply_decode, attn_apply_encode,
                     attn_apply_fullseq, attn_apply_paged, attn_apply_prefill,
                     attn_apply_prefill_paged, attn_apply_window_paged,
                     attn_cache_init, attn_init, attn_pages_init,
                     cross_attn_decode, cross_kv, mlp_apply, mlp_init,
                     norm_apply, norm_init)

PAGED_KINDS = ("attn_mlp", "attn_moe")
RECURRENT_KINDS = ("mamba", "rwkv")
DECODE_KINDS = ("attn_mlp", "attn_moe", "local", "shared_attn",
                "dec_attn_mlp") + RECURRENT_KINDS
FULL_KINDS = DECODE_KINDS + ("enc_attn_mlp",)
STATE_INIT = {"mamba": mamba_mod.mamba_state_init,
              "rwkv": rwkv_mod.rwkv_state_init}
AUX_KEYS = moe_mod.AUX_KEYS


def layer_init(kind: str, gen, cfg, lead=()):
    if kind not in FULL_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "mamba":
        return mamba_mod.mamba_init(gen, cfg, lead=lead)
    if kind == "rwkv":
        return rwkv_mod.rwkv_init(gen, cfg, lead=lead)
    dev = gen.device
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, device=dev, lead=lead),
         "attn": attn_init(gen, cfg, lead=lead),
         "ln2": norm_init(cfg.norm, cfg.d_model, device=dev, lead=lead)}
    if kind == "dec_attn_mlp":
        p = {"ln1": p["ln1"], "attn": p["attn"],
             "ln_x": norm_init(cfg.norm, cfg.d_model, device=dev, lead=lead),
             "xattn": attn_init(gen, cfg, lead=lead), "ln2": p["ln2"]}
    if kind == "attn_moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, lead=lead)
    else:
        p["mlp"] = mlp_init(gen, cfg, lead=lead)
    return p


def mask_kind(kind: str, cfg):
    """(attention mask kind, window) of a layer kind (the reference's
    ``_mask_kind``; its prefix length is ``prefix_len``'s)."""
    if kind == "enc_attn_mlp":
        return "bidir", 0
    if kind == "local":
        return "sliding", cfg.sliding_window
    if cfg.prefix_lm:
        return "prefix", 0
    return "causal", 0


def prefix_len(cfg, ctx) -> int:
    """The prefix-LM's prefix length: ``ctx["prefix_len"]`` (the vlm's
    patches), else ``cfg.n_prefix_tokens``, as the reference reads it; 0
    without ``cfg.prefix_lm``."""
    if not cfg.prefix_lm:
        return 0
    return (ctx or {}).get("prefix_len", cfg.n_prefix_tokens)


def enc_out(ctx):
    """The encoder's output (P, B, F, D) that a ``dec_attn_mlp`` layer
    cross-attends to; a stack without one cannot run such a layer."""
    if not ctx or ctx.get("enc_out") is None:
        raise ValueError("dec_attn_mlp layers cross-attend to an encoder's "
                         "output: the stack needs the audio family's "
                         "encoder (cfg.is_encoder_decoder) and its frames")
    return ctx["enc_out"]


def window_of(kind: str, cfg) -> int:
    """A layer's ring size bound: the sliding window of a ``local`` layer,
    0 (no ring) for the others."""
    return cfg.sliding_window if kind == "local" else 0


def ffn_apply(p, h, cfg):
    """The layer's second half on its normed input: the MoE (returns its
    aux values) or the MLP (aux None)."""
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], h, cfg)
    return mlp_apply(p["mlp"], h, cfg), None


def add_aux(total, aux):
    """Sum of two aux dicts (either may be None)."""
    if aux is None:
        return total
    if total is None:
        return dict(aux)
    return {k: total[k] + aux[k] for k in AUX_KEYS}


def stack_init(gen, cfg) -> Dict[str, Any]:
    """One particle's stack params; unit leaves lead with n_units. A
    ``shared_attn`` pattern position keeps ``{}`` in ``units``: its one
    copy sits at ``params["shared"]``."""
    params = {
        "head": tuple(layer_init(k, gen, cfg) for k in cfg.head_layers),
        "tail": tuple(layer_init(k, gen, cfg) for k in cfg.tail_layers),
    }
    if "shared_attn" in cfg.pattern:
        params["shared"] = layer_init("shared_attn", gen, cfg)
    params["units"] = tuple(
        {} if k == "shared_attn" else
        layer_init(k, gen, cfg, lead=(cfg.n_units,)) for k in cfg.pattern)
    return params


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


def unit_params(params, cfg):
    """Each unit's layer params in pattern order, as views (one
    ``unbind_units`` per stacked position); a ``shared_attn`` position
    takes ``params["shared"]`` itself."""
    cols = [None if kind == "shared_attn" else unbind_units(t)
            for kind, t in zip(cfg.pattern, params["units"])]
    return [[params["shared"] if c is None else c[u] for c in cols]
            for u in range(cfg.n_units)]


def layer_apply_full(kind: str, p, x, cfg, ctx=None):
    """One layer over a whole sequence: a recurrent block's chunked scan
    from a zero state, pre-norm attention + (MLP | MoE), or a decoder
    layer (causal self-attention, cross-attention over ``ctx["enc_out"]``,
    MLP). x (P, B, S, D) -> (x (P, B, S, D), aux: the MoE's aux values
    (P,) or None)."""
    if kind == "mamba":
        return mamba_mod.mamba_block_full(p, x, cfg)[0], None
    if kind == "rwkv":
        return rwkv_mod.rwkv_block_full(p, x, cfg)[0], None
    if kind == "dec_attn_mlp":
        enc = enc_out(ctx)
        x = x + attn_apply_fullseq(p["attn"], norm_apply(p["ln1"], x), cfg)
        kv = cross_kv(p["xattn"], enc, cfg)
        x = x + attn_apply_fullseq(p["xattn"], norm_apply(p["ln_x"], x), cfg,
                                   cross_kv=kv)
        return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg), None
    mk, window = mask_kind(kind, cfg)
    x = x + attn_apply_fullseq(p["attn"], norm_apply(p["ln1"], x), cfg,
                               kind=mk, window=window,
                               prefix_len=prefix_len(cfg, ctx))
    h, aux = ffn_apply(p, norm_apply(p["ln2"], x), cfg)
    return x + h, aux


def layer_apply_encode(p, x, cfg):
    """One encoder layer (``enc_attn_mlp``) in serving: bidirectional
    self-attention through the prefill kernel, then the MLP. x (P, B, F,
    D) -> x."""
    x = x + attn_apply_encode(p["attn"], norm_apply(p["ln1"], x), cfg)
    return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg)


def full_guard(cfg):
    """The training stack runs ``attn_mlp``, ``attn_moe`` and
    ``shared_attn`` layers (causal, or prefix-LM under ``cfg.prefix_lm``),
    ``local`` (sliding window), ``enc_attn_mlp`` (bidirectional),
    ``dec_attn_mlp`` (with an encoder's output), ``mamba`` and ``rwkv``,
    with or without a logit softcap: every kind of the reference."""
    kinds = tuple(cfg.head_layers) + tuple(cfg.pattern) + tuple(cfg.tail_layers)
    bad = sorted({k for k in kinds if k not in FULL_KINDS})
    if bad:
        raise ValueError(f"unknown layer kinds {bad}; the stack runs "
                         f"{FULL_KINDS}")


def _remat(cfg, body):
    """``body`` wrapped as the reference wraps its scanned unit: by
    ``checkpoint_policy(cfg.remat_policy)``; ``cfg.remat`` alone names
    "nothing_saveable", and neither means no checkpoint."""
    name = cfg.remat_policy or ("nothing_saveable" if cfg.remat else
                                "everything_saveable")
    return checkpoint_policy(name)(body)


def stack_apply_full(params, x, cfg, layer=layer_apply_full, ctx=None):
    """The training forward through the stack. x (P, B, S, D) -> (x (P,
    B, S, D), aux): aux the MoE layers' aux values summed over the layers
    (each (P,)), as the reference sums them, or {} for a stack with no MoE
    layer. The reference scans its units; here a Python loop takes each
    unit's params as views (``unbind_units``), and the unit body is
    checkpointed as ``_remat`` says. ``layer(kind, p, x, cfg, ctx)`` runs
    one layer and returns (x, aux or None); ``ctx`` carries what a layer
    reads besides x (the encoder's output, the prefix length; None for
    the decoder-only stacks). ``models.tp`` passes its
    tensor-parallel layer, with ``params`` a tree whose layers hold one
    tree per model position and ``x`` a list with one tensor per
    position. Every ``shared_attn`` occurrence reads ``params["shared"]``,
    so its gradient sums over the occurrences."""
    full_guard(cfg)

    def body(x, unit):
        aux = None
        for kind, p in zip(cfg.pattern, unit):
            x, a = layer(kind, p, x, cfg, ctx)
            aux = add_aux(aux, a)
        return x, aux

    body = _remat(cfg, body)
    aux = None
    for kind, p in zip(cfg.head_layers, params["head"]):
        x, a = layer(kind, p, x, cfg, ctx)
        aux = add_aux(aux, a)
    if cfg.n_units:
        for unit in unit_params(params, cfg):
            x, a = body(x, unit)
            aux = add_aux(aux, a)
    for kind, p in zip(cfg.tail_layers, params["tail"]):
        x, a = layer(kind, p, x, cfg, ctx)
        aux = add_aux(aux, a)
    return x, aux or {}


def _write_state(cache, new):
    """Copy a layer's new state (a recurrent block's, a decoder layer's
    cross k / v) into its cache IN PLACE, so a captured step's replay
    carries it."""
    for k, t in new.items():
        cache[k].copy_(t)
    return cache


def layer_apply_prefill(kind: str, p, x, cfg, cache, ctx=None):
    """One layer over a whole prompt that also builds the layer's dense
    decode cache (a ring for a ``local`` layer) or, for a recurrent
    block, writes its scan's final state, the counterpart of the
    cache-building branch of the reference's ``layer_apply_full``: the
    layer's empty cache is filled in place. A decoder layer also writes
    the cross-attention's k / v of ``ctx["enc_out"]`` into its cache's
    ``xk`` / ``xv``; under ``cfg.prefix_lm`` the self-attention takes the
    prefix-LM mask over ``prefix_len(cfg, ctx)`` positions. x (P, B, S,
    D). Returns (x, cache)."""
    if kind == "mamba":
        x, new = mamba_mod.mamba_block_full(p, x, cfg)
        return x, _write_state(cache, new)
    if kind == "rwkv":
        x, new = rwkv_mod.rwkv_block_full(p, x, cfg)
        return x, _write_state(cache, new)
    if kind == "dec_attn_mlp":
        enc = enc_out(ctx)
        h, _ = attn_apply_prefill(p["attn"], norm_apply(p["ln1"], x), cfg,
                                  cache["self"])
        x = x + h
        kv = cross_kv(p["xattn"], enc, cfg)
        _write_state(cache, {"xk": kv[0], "xv": kv[1]})
        x = x + attn_apply_fullseq(p["xattn"], norm_apply(p["ln_x"], x), cfg,
                                   cross_kv=kv)
        return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg), cache
    h, cache = attn_apply_prefill(p["attn"], norm_apply(p["ln1"], x), cfg,
                                  cache, window=window_of(kind, cfg),
                                  prefix_len=prefix_len(cfg, ctx))
    x = x + h
    return x + ffn_apply(p, norm_apply(p["ln2"], x), cfg)[0], cache


def layer_apply_decode(kind: str, p, x, cfg, cache, ctx):
    """One-token decode of one layer over its dense cache (a ring for a
    ``local`` layer) or its recurrent state. x (P, B, 1, D); ctx: cur_pos
    (a 0-d int tensor on the device). The cache is updated in place. A
    decoder layer's cross-attention reads its cached encoder k / v
    (``cross_attn_decode``). Returns (x, cache)."""
    if kind == "mamba":
        x, new = mamba_mod.mamba_block_decode(p, x, cfg, cache)
        return x, _write_state(cache, new)
    if kind == "rwkv":
        x, new = rwkv_mod.rwkv_block_decode(p, x, cfg, cache)
        return x, _write_state(cache, new)
    if kind == "dec_attn_mlp":
        h, _ = attn_apply_decode(p["attn"], norm_apply(p["ln1"], x), cfg,
                                 cache["self"], cur_pos=ctx["cur_pos"])
        x = x + h
        x = x + cross_attn_decode(p["xattn"], norm_apply(p["ln_x"], x), cfg,
                                  cache["xk"], cache["xv"])
        return x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x), cfg), cache
    h, cache = attn_apply_decode(p["attn"], norm_apply(p["ln1"], x), cfg,
                                 cache, cur_pos=ctx["cur_pos"],
                                 window=window_of(kind, cfg))
    x = x + h
    return x + ffn_apply(p, norm_apply(p["ln2"], x), cfg)[0], cache


def decode_guard(cfg):
    """The dense-cache path runs ``attn_mlp``, ``attn_moe``,
    ``shared_attn`` and ``local`` (ring cache) layers, ``dec_attn_mlp``
    (self-attention cache and the encoder's cross k / v) and the
    recurrent ``mamba`` and ``rwkv`` (their scan state), with or without
    a logit softcap or a prefix-LM prefill. An encoder's
    ``enc_attn_mlp`` layer keeps no cache, in the reference too: a stack
    of them has no decode."""
    kinds = tuple(cfg.head_layers) + tuple(cfg.pattern) + tuple(cfg.tail_layers)
    bad = sorted({k for k in kinds if k not in DECODE_KINDS})
    if bad:
        raise ValueError(f"dense-cache decode runs {DECODE_KINDS} stacks "
                         f"only, got {bad}")


def stack_apply_prefill(params, x, cfg, caches, ctx=None):
    """Prompt prefill that fills the empty dense decode caches of
    ``stack_cache_init`` in place. x (P, B, S, D); ctx: the encoder's
    output and the prefix length, where the stack reads them. Returns (x,
    caches)."""
    return _stack_apply_state(params, x, cfg, caches, cache_unit,
                              lambda kind, p, x, c: layer_apply_prefill(
                                  kind, p, x, cfg, c, ctx))


def stack_apply_decode(params, x, cfg, caches, ctx):
    """One decode step over the dense caches. x (P, B, 1, D); ctx:
    cur_pos. Returns (x, caches), updated in place."""
    return _stack_apply_state(params, x, cfg, caches, cache_unit,
                              lambda kind, p, x, c: layer_apply_decode(
                                  kind, p, x, cfg, c, ctx))


def stack_layers(params, state, cfg, pick):
    """(where, kind, p, s) of every layer of the stack, in order: ``where``
    is "head", "units" or "tail"; a unit layer's params are views
    ``a[:, u]`` of the stacked tree (a ``shared_attn`` occurrence's are
    ``params["shared"]``) and its state (pages, a dense cache or a
    recurrent state) is ``pick(unit state, u)``, so in-place writes land
    in the stacked state."""
    for kind, p, s in zip(cfg.head_layers, params["head"], state["head"]):
        yield "head", kind, p, s
    for u in range(cfg.n_units):
        for j, kind in enumerate(cfg.pattern):
            p = params["shared"] if kind == "shared_attn" else tree_map(
                lambda a: a[:, u], params["units"][j])
            yield "units", kind, p, pick(state["units"][j], u)
    for kind, p, s in zip(cfg.tail_layers, params["tail"], state["tail"]):
        yield "tail", kind, p, s


def cache_unit(c, u: int):
    """Unit u's dense cache: k/v ``[:, u]``, pos ``[u]``; a decoder
    layer's: its ``self`` cache so, ``xk`` / ``xv`` ``[:, u]``; or its
    recurrent state: every leaf ``[:, u]``."""
    if "self" in c:
        return {"self": cache_unit(c["self"], u), "xk": c["xk"][:, u],
                "xv": c["xv"][:, u]}
    if "pos" not in c:
        return tree_map(lambda a: a[:, u], c)
    return {"k": c["k"][:, u], "v": c["v"][:, u], "pos": c["pos"][u]}


def page_unit(pg, u: int):
    """Unit u's page pool: every leaf ``[:, u]``."""
    return tree_map(lambda a: a[:, u], pg)


def _stack_apply_state(params, x, cfg, state, pick, layer_fn):
    """Run ``layer_fn(kind, p, x, state)`` over the stack (``stack_layers``),
    casting x back to its dtype after each unit layer as the reference's
    scan carry does. Returns (x, state)."""
    dt = x.dtype
    for where, kind, p, st in stack_layers(params, state, cfg, pick):
        x, _ = layer_fn(kind, p, x, st)
        if where == "units":
            x = x.to(dt)
    return x, state


def stack_cache_init(cfg, particles: int, batch: int, seq_len: int, *,
                     dtype, device):
    """Empty dense caches for ``particles`` stacked particles: per
    attention layer k/v (P, B, C, KVH, hd) zeros and pos (B, C) = -1, C =
    seq_len, or min(sliding_window, seq_len) for a ``local`` layer's ring
    (each pattern position keeps its own C, each ``shared_attn``
    occurrence its own cache); per decoder layer ``{"self": that cache,
    "xk", "xv": (P, B, n_frames, KVH, hd) zeros}``, the encoder's k / v
    the prefill writes; per recurrent layer its zero state
    (``mamba_state_init``, ``rwkv_state_init``); unit layers stacked on
    n_units (k/v (P, n_units, ...), pos (n_units, ...), a state's leaves
    (P, n_units, ...))."""
    decode_guard(cfg)

    def one(kind, lead=()):
        if kind in STATE_INIT:
            return STATE_INIT[kind](cfg, particles, batch, dtype=dtype,
                                    device=device, lead=lead)
        cache = attn_cache_init(cfg, particles, batch, seq_len, dtype=dtype,
                                device=device, lead=lead,
                                window=window_of(kind, cfg))
        if kind != "dec_attn_mlp":
            return cache
        shape = (particles,) + tuple(lead) + (batch, cfg.n_frames,
                                              cfg.n_kv_heads, cfg.hd)
        return {"self": cache,
                "xk": torch.zeros(shape, dtype=dtype, device=device),
                "xv": torch.zeros(shape, dtype=dtype, device=device)}

    return {"head": tuple(one(k) for k in cfg.head_layers),
            "units": tuple(one(k, (cfg.n_units,)) for k in cfg.pattern),
            "tail": tuple(one(k) for k in cfg.tail_layers)}


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
        write_index=ctx["write_index"],
        use_kernel=ctx.get("decode_kernel", True))
    x = x + h
    return x + ffn_apply(p, norm_apply(p["ln2"], x), cfg)[0], pages


def _layer_apply_prefill_paged(kind, p, x, cfg, pages, ctx):
    h, pages = attn_apply_prefill_paged(
        p["attn"], norm_apply(p["ln1"], x), cfg, pages,
        write_index=ctx["write_index"])
    x = x + h
    return x + ffn_apply(p, norm_apply(p["ln2"], x), cfg)[0], pages


def _stack_apply_paged_common(params, x, cfg, pages, ctx, layer_fn):
    return _stack_apply_state(params, x, cfg, pages, page_unit,
                              lambda kind, p, x, pg: layer_fn(
                                  kind, p, x, cfg, pg, ctx))


def stack_apply_paged(params, x, cfg, pages, ctx):
    """One decode step over the paged pool. x (P, B, 1, D); ctx:
    block_tables (B, n_pmax), seq_lens (B,), write_index
    (``blocks.paged_write_index``). Returns (x, pages) — the same page
    tensors, updated in place."""
    return _stack_apply_paged_common(params, x, cfg, pages, ctx,
                                     _layer_apply_paged)


def _layer_apply_window_paged(kind, p, x, cfg, pages, ctx):
    h, pages = attn_apply_window_paged(
        p["attn"], norm_apply(p["ln1"], x), cfg, pages,
        block_tables=ctx["block_tables"], seq_lens=ctx["seq_lens"],
        write_index=ctx["write_index"])
    x = x + h
    return x + ffn_apply(p, norm_apply(p["ln2"], x), cfg)[0], pages


def stack_apply_window_paged(params, x, cfg, pages, ctx):
    """Speculative verify over a drafted window. x (P, B, W, D); ctx:
    block_tables (B, n_pmax), seq_lens (B,) (position of window token 0,
    -1 = inactive), write_index (``blocks.window_write_index``). Returns
    (x, pages) — the same page tensors, updated in place."""
    return _stack_apply_paged_common(params, x, cfg, pages, ctx,
                                     _layer_apply_window_paged)


def stack_apply_prefill_paged(params, x, cfg, pages, ctx):
    """Prompt prefill for one sequence into the pool. x (P, 1, Sp, D);
    ctx: write_index (``blocks.prefill_write_index``). Returns (x,
    pages)."""
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
