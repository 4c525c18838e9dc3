"""Tensor parallelism over a model group (Megatron layout; the model axis
of a 2D placement).

Under a model axis of size ``m`` a data position's params arrive as a
``core.tree.Group``: ``shards[j]`` is model position j's part of the
stacked tree, split by ``sharding.rules`` (the q/k/v, ``wi|wg|w1``
columns, the ``wo|w2`` rows, the vocab of ``embed``; the rest
replicated). These functions run the model's forward on the group,
layer by layer: each position computes with its local head counts
(``n_heads / m``, ``n_kv_heads / m``, ``d_ff / m``) on its own device,
through the same blocks and kernels as one device, and the activations
between blocks are a list with one tensor per position.

  * The column-parallel products (q/k/v, ``wi|wg|w1``) take the
    replicated residual; the row-parallel ones (``attn/wo``,
    ``mlp/wo|w2``) give partial sums, which ``reduce_sum`` adds in
    position order on the first position and hands back to every
    position (the same bits at each). A row-parallel product's bias
    (``mlp/w2/b``) has no rule: it is added once, after the sum.
  * A kv-head count the axis does not divide leaves ``wk`` / ``wv``
    split by columns (or replicated) while the kv heads are not: the
    weights are joined across the group, every position projects every
    kv head (and writes them all into its replicated page pool or cache)
    and its q heads read the kv heads their global index maps to
    (``blocks.kv_heads``).
  * MoE layers (``attn_moe``): the experts' leading E axis rides the
    axis (``wi`` / ``wg`` / ``wo``), the router is replicated and the
    shared experts are an MLP as above. Each position routes every
    token with its copy of the router (the same routing at each),
    computes only its own E / m experts' slots and combines them into a
    partial output; the partials are summed as a row-parallel product's
    are. A count the axis does not divide leaves the experts replicated
    (the rules' divisibility drop): each position then computes them
    all. The aux values come from the first position's router.
  * The tied embedding is split over the vocab: a lookup takes the
    local vocab range (zeros elsewhere) and the group sums the parts,
    which is exact; the logits come out vocab-split and are joined on
    the first position before the heads and the loss.
  * The backward is autograd's through these lists: a reduction's
    backward hands every partial the summed gradient of its copies, and
    the gradient of a replicated leaf comes back per position as a
    partial; ``group_grads`` sums those in position order and gives each
    copy the sum (Megatron's f / g operators, taken at the leaves).

A group whose leaves are all replicated (no rule matched: the UNet, a
user's module) runs the plain model on its first position
(``entry``). ``maybe_shard`` (``sharding.policy``) stays at the
reference's call sites: under an activation policy it records each
position's shapes.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence

import torch

from ..core.tree import Group, tree_map
from ..obs.device import moved
from ..sharding.policy import maybe_shard
from . import blocks
from . import moe as moe_mod
from .blocks import norm_apply
from .transformer import (RECURRENT_KINDS, cache_unit, decode_guard,
                          mask_kind, page_unit, paged_guard,
                          stack_apply_full, stack_layers, unbind_units,
                          window_of)


# --------------------------------------------------------------------------
# the group and its collectives
# --------------------------------------------------------------------------

def has_split(group) -> bool:
    """Whether a Group holds a leaf the model axis splits (a Group from
    model code, with no dims, is taken to)."""
    if not isinstance(group, Group):
        return False
    return group.dims is None or any(d is not None
                                     for d in group.dims.values())


def entry(params):
    """What a model function runs on: the first position's tree for a
    Group with nothing split, else ``params`` itself."""
    if isinstance(params, Group) and not has_split(params):
        return params.shards[0]
    return params


def _on(x, device):
    """A tensor (or a tree of them) on ``device``."""
    return tree_map(lambda t: t.to(device)
                    if isinstance(t, torch.Tensor) else t, x)


def reduce_sum(parts: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The row-parallel reduction: the partials summed in position order
    on the first position, and every position handed those bits. Inside
    a count each transfer is charged to the position it reaches as an
    "all-reduce" (``obs.device.moved``)."""
    s = parts[0]
    for p in parts[1:]:
        s = s + moved(p, s.device, "all-reduce")
    return [moved(s, d, "all-reduce") for d in devices]


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices) -> List[torch.Tensor]:
    """The parts joined along ``dim`` in position order, at every
    position; inside a count each transfer is charged to the position it
    reaches as an "all-gather"."""
    full = torch.cat([moved(p, parts[0].device, "all-gather")
                      for p in parts], dim)
    return [moved(full, d, "all-gather") for d in devices]


def group_grads(params: Group, grads: List[List]) -> Group:
    """Per-position gradients (``grads[j]``: position j's, one per leaf of
    its shard in ``tree_flatten`` order, None for a leaf that took no
    part) -> the group's gradient tree: a split leaf's gradient is its
    shard's; a replicated leaf's copies each took part of the forward,
    so its gradient is the sum of the copies' (in position order, on the
    first position), given to every copy."""
    from ..core.tree import tree_flatten
    from ..sharding.rules import named_leaves
    paths = [p for p, _ in named_leaves(params.shards[0])]
    per = [tree_flatten(s)[0] for s in params.shards]
    out = [list(g) for g in grads]
    for k, path in enumerate(paths):
        split = params.dims is None or params.dims[path] is not None
        if split:
            for j in range(len(out)):
                if out[j][k] is None:
                    out[j][k] = torch.zeros_like(per[j][k])
            continue
        parts = [g[k] for g in grads if g[k] is not None]
        if not parts:
            parts = [torch.zeros_like(per[0][k])]
        s = parts[0]
        for g in parts[1:]:
            s = s + g.to(s.device)
        for j, d in enumerate(params.devices):
            out[j][k] = s.to(d)
    return params.like(tree_flatten(sh)[1](g)
                       for sh, g in zip(params.shards, out))


class _Local:
    """A model config seen by one model position: the reference's fields
    with local head counts, an explicit head dim and, when the model axis
    does not divide the kv heads, the window of kv heads its q heads read
    (``kv_window``)."""

    def __init__(self, cfg, **kw):
        self._cfg = cfg
        self.__dict__.update(kw)

    def __getattr__(self, name):
        return getattr(self._cfg, name)


# --------------------------------------------------------------------------
# one layer over the group
# --------------------------------------------------------------------------

def _attn_plan(pa: List[Dict], cfg, devices):
    """(per-position attention params, per-position local configs,
    whether the output is partial sums) of one attention layer."""
    m = len(pa)
    hd, H, KVH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cq = pa[0]["wq"]["w"].shape[-1]
    if cq == H * hd:            # the axis does not divide the q columns
        return pa, [cfg] * m, False
    if H % m:
        raise NotImplementedError(
            f"{H} q heads split over a model axis of {m}: the q columns "
            "would cut a head (pick a model axis that divides n_heads; "
            "ROADMAP.md queue 1, item 31)")
    hl = H // m
    ck = pa[0]["wk"]["w"].shape[-1]
    if ck * m == KVH * hd and KVH % m == 0:
        local = _Local(cfg, n_heads=hl, n_kv_heads=KVH // m, hd=hd)
        return pa, [local] * m, True
    # every position projects every kv head: the columns joined
    if ck != KVH * hd:
        pa = [dict(p) for p in pa]
        for name in ("wk", "wv"):
            joined = {leaf: all_gather([p[name][leaf] for p in pa], -1,
                                       devices)
                      for leaf in pa[0][name]}
            for j, p in enumerate(pa):
                p[name] = {leaf: joined[leaf][j] for leaf in joined}
    g = H // KVH
    locals_ = []
    for j in range(m):
        lo, hi = (j * hl) // g, -(-((j + 1) * hl) // g)
        n_kv = hi - lo
        if hl % n_kv or any((j * hl + h) // g - lo != h // (hl // n_kv)
                            for h in range(hl)):
            raise NotImplementedError(
                f"{hl} q heads a position over {n_kv} kv heads do not "
                "group evenly")
        locals_.append(_Local(cfg, n_heads=hl, n_kv_heads=KVH, hd=hd,
                              kv_window=(lo, hi)))
    return pa, locals_, True


def _mlp(pm: List[Dict], xs, cfg, devices):
    """The MLP over the group: column- then row-parallel, the partials
    summed and the row product's bias added after the sum; a replicated
    MLP (the axis does not divide d_ff) runs whole at every position."""
    up = pm[0]["wi"] if "wi" in pm[0] else pm[0]["w1"]
    if up["w"].shape[-1] == cfg.d_ff:
        return [blocks.mlp_apply(p, x, cfg) for p, x in zip(pm, xs)]
    down = "wo" if "wi" in pm[0] else "w2"
    parts = []
    for p, x in zip(pm, xs):
        p = dict(p, **{down: {"w": p[down]["w"]}})
        parts.append(blocks.mlp_apply(p, x, cfg))
    ys = reduce_sum(parts, devices)
    if "b" in pm[0][down]:
        ys = [y + blocks._per_particle(p[down]["b"].to(y.dtype), y)
              for p, y in zip(pm, ys)]
    return ys


def _moe(pm: List[Dict], xs, cfg, devices):
    """The MoE over the group: (outputs, one per position; the aux values
    of the first position's router). Experts split over the axis give
    partial outputs, summed in position order; the shared experts run as
    an MLP of ``shared_d_ff`` over the group."""
    El = pm[0]["wi"].shape[-3]
    split = El != cfg.n_experts
    P, B, S, D = xs[0].shape
    parts, aux = [], None
    for j, (p, x) in enumerate(zip(pm, xs)):
        xt = x.reshape(P, B * S, D)
        r = moe_mod.route(p, xt, cfg)
        parts.append(moe_mod.experts_apply(p, xt, r, cfg,
                                           j * El if split else 0))
        if j == 0:
            aux = moe_mod.aux_values(r, cfg)
    ys = reduce_sum(parts, devices) if split else parts
    if "shared" in pm[0]:
        sh = _mlp([p["shared"] for p in pm],
                  [x.reshape(P, B * S, D) for x in xs],
                  _Local(cfg, d_ff=cfg.shared_d_ff), devices)
        ys = [y + s for y, s in zip(ys, sh)]
    return [maybe_shard(y, "moe_tokens").reshape(P, B, S, D)
            for y in ys], aux


def _layer(ps, xs, cfg, devices, attn):
    """One pre-norm attention + (MLP | MoE) layer over the group.
    ``attn(p_attn, h, local cfg, j)`` is position j's attention (through
    its ``wo`` rows); returns (the new residuals, one per position; the
    MoE's aux values or None)."""
    pa, local, partial = _attn_plan([p["attn"] for p in ps], cfg, devices)
    hs = [attn(pa[j], norm_apply(ps[j]["ln1"], xs[j]), local[j], j)
          for j in range(len(ps))]
    if partial:
        hs = reduce_sum(hs, devices)
    xs = [maybe_shard(x + h, "residual") for x, h in zip(xs, hs)]
    normed = [norm_apply(p["ln2"], x) for p, x in zip(ps, xs)]
    if "moe" in ps[0]:
        ys, aux = _moe([p["moe"] for p in ps], normed, cfg, devices)
    else:
        ys, aux = _mlp([p["mlp"] for p in ps], normed, cfg, devices), None
    return [x + y for x, y in zip(xs, ys)], aux


def _zip(shards):
    """The group's stack as one tree whose layers each hold a list of the
    model positions' trees: what ``transformer.stack_layers`` and
    ``stack_apply_full`` walk for a group."""
    return {w: tuple(list(ps) for ps in zip(*(s[w] for s in shards)))
            for w in ("head", "units", "tail")}


def _full_layer(kind, ps, xs, cfg, ctx=None, *, devices):
    """One training layer over the group (``layer_apply_full``'s
    counterpart): (residuals, aux or None). ``ctx`` is None: the stacks
    that read one are refused (``recurrent_guard``)."""
    mk, window = mask_kind(kind, cfg)
    return _layer(ps, xs, cfg, devices,
                  lambda p, h, lc, j: blocks.attn_apply_fullseq(
                      p, h, lc, kind=mk, window=window))


# --------------------------------------------------------------------------
# embedding and logits
# --------------------------------------------------------------------------

def _embed(shards, tokens, dtype, cfg, devices):
    """tokens (B, S) -> the residual (P, B, S, D) at every position: each
    position looks up its vocab range (zeros elsewhere) and the group
    sums the parts (exact: one part is nonzero per token)."""
    table = shards[0]["embed"]
    if table.shape[-2] == cfg.vocab_size:
        x = table[:, tokens.long()].to(dtype)
        return [maybe_shard(x.to(d), "residual") for d in devices]
    vl = table.shape[-2]
    parts = []
    for j, (s, d) in enumerate(zip(shards, devices)):
        t = tokens.to(d).long() - j * vl
        ok = (t >= 0) & (t < vl)
        e = s["embed"][:, t.clamp(0, vl - 1)].to(dtype)
        parts.append(torch.where(ok[None, ..., None], e, 0.0).to(dtype))
    return [maybe_shard(x, "residual") for x in reduce_sum(parts, devices)]


def logits(group: Group, x, cfg):
    """x (P, ..., D) on the first position -> the logits (P, ..., V)
    there: each position's vocab range from its part of the head, joined
    in position order (``api._lm_logits`` over a group)."""
    from .api import _lm_logits
    first = _lm_logits(group.shards[0], x, cfg)
    if first.shape[-1] == cfg.vocab_size:
        return first
    rest = [_lm_logits(s, x.to(d), cfg).to(x.device)
            for s, d in zip(group.shards[1:], group.devices[1:])]
    return torch.cat([first] + rest, -1)


# --------------------------------------------------------------------------
# the training forward (``api.loss_fn`` takes its output)
# --------------------------------------------------------------------------

def vit_forward(group: Group, images, cfg):
    """images (B, 28, 28, 1) -> logits (P, B, n_classes) on the first
    position: ``vit_apply`` on the first position's tree (the patch
    embedding, class token, positions, final norm and head are
    replicated), its encoder layers run over the group."""
    from .vit import vit_apply
    devices = group.devices

    def encoder(x):
        xs = [x.to(d) for d in devices]
        for unit in unbind_units([s["units"] for s in group.shards]):
            xs, _ = _full_layer("enc_attn_mlp", unit, xs, cfg,
                                devices=devices)
        return xs[0]

    return vit_apply(group.shards[0], images, cfg, encoder=encoder)


def recurrent_guard(cfg):
    """The model axis runs decoder-only attention stacks only: the
    recurrent blocks (``mamba``, ``rwkv``) and zamba2's ``shared_attn``
    have rules in ``sharding.rules`` but no tensor-parallel layer
    (ROADMAP.md queue 1, item 25); whisper's encoder-decoder
    (``dec_attn_mlp``, the encoder) and the prefix-LM neither
    (``encdec_guard``, item 27)."""
    kinds = set(cfg.head_layers) | set(cfg.pattern) | set(cfg.tail_layers)
    bad = sorted(kinds & set(RECURRENT_KINDS + ("shared_attn",)))
    if bad:
        raise NotImplementedError(
            f"{bad} layers have no tensor-parallel form on the model axis "
            f"(ROADMAP.md queue 1, item 25)")
    encdec_guard(cfg)


def encdec_guard(cfg):
    """The encoder-decoder stack (``dec_attn_mlp`` layers and the
    encoder over the frames) and the prefix-LM (its patches, its mask)
    have no tensor-parallel form on the model axis (ROADMAP.md queue 1,
    item 27); the ViT's encoder has one (``vit_forward``)."""
    kinds = set(cfg.head_layers) | set(cfg.pattern) | set(cfg.tail_layers)
    if cfg.family in ("audio", "vlm") or cfg.prefix_lm \
            or "dec_attn_mlp" in kinds:
        raise NotImplementedError(
            f"the {cfg.family} family's stack (encoder-decoder or "
            f"prefix-LM) has no tensor-parallel form on the model axis "
            f"(ROADMAP.md queue 1, item 27)")


def forward(group, batch, cfg):
    """``api.forward`` over a group: the output on the first position
    (the LM's final-norm hidden states and its MoE aux values, the ViT's
    logits)."""
    from . import api
    if not has_split(group):
        return api.forward(entry(group), batch, cfg)
    recurrent_guard(cfg)
    if cfg.family == "vision":
        return vit_forward(group, batch["images"], cfg), {}
    if cfg.family not in api.LM_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no tensor-parallel forward")
    shards, devices = group.shards, group.devices
    xs = _embed(shards, batch["tokens"], api._dtype(cfg), cfg, devices)
    xs, aux = stack_apply_full(_zip(shards), xs, cfg,
                               layer=functools.partial(_full_layer,
                                                       devices=devices))
    return norm_apply(shards[0]["final_norm"], xs[0]), aux


# --------------------------------------------------------------------------
# serving: the paged pool and the dense caches
# --------------------------------------------------------------------------

def _serve(group: Group, tokens, cfg, state: Group, ctx, attn, pick):
    """Embedding, the stack over each position's state (``state``: a Group
    of page pools or dense caches; ``pick`` takes a unit's) and the final
    norm, on the first position; ``ctx`` (the step's block tables,
    lengths, write index) is moved to every position. ``attn(p, h, lc,
    st, ctx, window)`` is one position's attention; ``window`` is a
    ``local`` layer's ring bound (0 for the others)."""
    from .api import _dtype
    shards, devices = group.shards, group.devices
    ctxs = [_on(ctx, d) for d in devices]
    xs = _embed(shards, tokens, _dtype(cfg), cfg, devices)
    dt = xs[0].dtype
    for where, kind, ps, sts in stack_layers(
            _zip(shards), _zip(state.shards), cfg,
            lambda s, u: [pick(x, u) for x in s]):
        w = window_of(kind, cfg)
        xs, _ = _layer(ps, xs, cfg, devices,
                       lambda p, h, lc, j: attn(p, h, lc, sts[j], ctxs[j],
                                                w))
        if where == "units":
            xs = [x.to(dt) for x in xs]
    return norm_apply(shards[0]["final_norm"], xs[0])


def _paged_attn(p, h, lc, st, ctx, window):
    return blocks.attn_apply_paged(
        p, h, lc, st, block_tables=ctx["block_tables"],
        seq_lens=ctx["seq_lens"], write_index=ctx["write_index"],
        use_kernel=ctx.get("decode_kernel", True))[0]


def _window_attn(p, h, lc, st, ctx, window):
    return blocks.attn_apply_window_paged(
        p, h, lc, st, block_tables=ctx["block_tables"],
        seq_lens=ctx["seq_lens"], write_index=ctx["write_index"])[0]


def _prefill_paged_attn(p, h, lc, st, ctx, window):
    return blocks.attn_apply_prefill_paged(
        p, h, lc, st, write_index=ctx["write_index"])[0]


def decode_step_paged(group, tokens, pages, ctx, cfg):
    """``api.decode_step_paged`` over a group (``ctx`` built there)."""
    paged_guard(cfg)
    x = _serve(group, tokens.clamp(min=0)[:, None], cfg, pages, ctx,
               _paged_attn, page_unit)
    return logits(group, x, cfg)[:, :, 0], pages


def decode_window_paged(group, tokens, pages, ctx, cfg):
    """``api.decode_window_paged`` over a group."""
    paged_guard(cfg)
    x = _serve(group, tokens.clamp(min=0), cfg, pages, ctx, _window_attn,
               page_unit)
    return logits(group, x, cfg), pages


def prefill_paged(group, tokens, pages, ctx, n_tokens, cfg):
    """``api.prefill_paged`` over a group."""
    paged_guard(cfg)
    x = _serve(group, tokens, cfg, pages, ctx, _prefill_paged_attn,
               page_unit)
    last = (n_tokens.long() - 1).clamp(min=0).reshape(1)
    return logits(group, x.index_select(2, last)[:, :, 0], cfg), pages


def prefill(group: Group, tokens, cfg, C: int):
    """``api.prefill`` over a group: the dense caches a Group of each
    position's (its local kv heads, or every kv head when the axis does
    not divide them)."""
    from .api import _cache_dtype
    from .transformer import stack_cache_init
    decode_guard(cfg)
    recurrent_guard(cfg)
    B, S = tokens.shape
    plan = _plan_locals(group, cfg)
    caches = Group([stack_cache_init(lc, s["embed"].shape[0], B, C,
                                     dtype=_cache_dtype(cfg), device=d)
                    for s, lc, d in zip(group.shards, plan, group.devices)],
                   None, group.devices)
    x = _serve(group, tokens, cfg, caches, {},
               lambda p, h, lc, st, ctx, w: blocks.attn_apply_prefill(
                   p, h, lc, st, window=w)[0], cache_unit)
    return logits(group, x[:, :, -1:], cfg)[:, :, 0], caches


def decode_step(group: Group, token, caches: Group, cur_pos, cfg):
    """``api.decode_step`` over a group (``cur_pos`` a 0-d device tensor,
    checked by the caller)."""
    decode_guard(cfg)
    recurrent_guard(cfg)
    x = _serve(group, token.clamp(min=0)[:, None], cfg, caches,
               {"cur_pos": cur_pos},
               lambda p, h, lc, st, ctx, w: blocks.attn_apply_decode(
                   p, h, lc, st, cur_pos=ctx["cur_pos"], window=w)[0],
               cache_unit)
    return logits(group, x, cfg)[:, :, 0], caches


def _plan_locals(group: Group, cfg) -> List[Any]:
    """Each position's local config of the first attention layer (every
    layer has the same)."""
    shards = group.shards
    first = next(w for w in ("units", "head", "tail") if shards[0][w])
    pa = [s[first][0]["attn"] for s in shards]
    if first == "units":
        pa = [tree_map(lambda a: a[:, 0], p) for p in pa]
    return _attn_plan(pa, cfg, group.devices)[1]
