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
  * A q-head count the axis does not divide but a multiple r of which
    the axis is (gemma3-4b's and paligemma-3b's 8 at 16): the r
    positions that share head h join its wq columns, each runs the
    whole head (one local head, the kv window it reads) and multiplies
    only its slice of the head's dims by its ``wo`` rows, which are that
    slice (``blocks.attn_out``). An axis that neither divides the q heads
    nor is a multiple of them raises (ROADMAP.md item 31).
  * The recurrent blocks (``mamba``, ``rwkv``) run over the group in
    ``models.tp_recurrent``; zamba2's ``shared_attn`` runs as an
    attention layer, one copy of ``params["shared"]`` a position, its
    gradient summed over the occurrences by autograd. whisper's encoder
    runs its layers over the group (its output replicated) and a
    decoder layer's cross-attention is split as its self-attention is,
    the cross k / v projected per position from the replicated encoder
    output; paligemma's patches go in front of the text at every
    position and the prefix length reaches every attention layer.
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

Where the axis does not divide a block's heads (or ``d_ff``), the block
runs whole at every position, on weights the rules left whole or on its
shards joined, and gives a replicated output, not a partial.

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
from . import tp_recurrent
from .blocks import norm_apply
from .transformer import (RECURRENT_KINDS, _write_state, cache_unit,
                          decode_guard, mask_kind, page_unit, paged_guard,
                          prefix_len, stack_apply_full, stack_layers,
                          unbind_units, unit_params, window_of)


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
    (``kv_window``); when it shares its q head, the slice of the head's
    dims its ``wo`` rows take (``wo_cols``)."""

    def __init__(self, cfg, **kw):
        self._cfg = cfg
        self.__dict__.update(kw)

    def __getattr__(self, name):
        return getattr(self._cfg, name)


# --------------------------------------------------------------------------
# one layer over the group
# --------------------------------------------------------------------------

def _attn_locals(cq: int, ck: int, cfg, m: int):
    """(mode, each position's local config) of an attention layer whose
    wq / wk columns at a position are ``cq`` / ``ck``:

      * "whole": the axis does not divide the q columns, so the rules
        left the layer whole: it runs whole at every position;
      * "heads": each position its n_heads / m q heads and
        n_kv_heads / m kv heads;
      * "kv": its q heads over every kv head (the axis does not divide
        the kv heads: wk / wv joined across the group), reading the
        window of kv heads its q heads map to (``kv_window``);
      * "shared": the axis is a multiple r of the q heads, so r positions
        share head h = j // r: each runs the whole head (wq's columns
        joined among the r, every kv head joined, the head's kv window)
        and multiplies only its slice of the head's dims by its wo rows,
        which are exactly that slice (``wo_cols``).
    """
    hd, H, KVH = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if cq == H * hd:
        return "whole", [cfg] * m
    if H % m == 0:
        hl = H // m
        if ck * m == KVH * hd and KVH % m == 0:
            return "heads", [_Local(cfg, n_heads=hl, n_kv_heads=KVH // m,
                                    hd=hd)] * m
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
        return "kv", locals_
    if m % H:
        raise NotImplementedError(
            f"{H} q heads over a model axis of {m}: the axis neither "
            "divides the heads nor is a multiple of them, so the q columns "
            "would cut a head across positions that do not share it (pick "
            "a model axis that divides n_heads or that n_heads divides; "
            "ROADMAP.md queue 1, item 31)")
    r, g, w = m // H, H // KVH, hd // (m // H)
    return "shared", [_Local(cfg, n_heads=1, n_kv_heads=KVH, hd=hd,
                             kv_window=(j // r // g, j // r // g + 1),
                             wo_cols=((j % r) * w, (j % r + 1) * w))
                      for j in range(m)]


def _joined(pa: List[Dict], name: str, members, devices):
    """``pa[j][name]``'s leaves joined by columns among ``members`` (model
    positions), handed to each member (in place in ``pa``)."""
    joined = {leaf: all_gather([pa[j][name][leaf] for j in members], -1,
                               [devices[j] for j in members])
              for leaf in pa[members[0]][name]}
    for i, j in enumerate(members):
        pa[j][name] = {leaf: joined[leaf][i] for leaf in joined}


def _attn_plan(pa: List[Dict], cfg, devices):
    """(per-position attention params, per-position local configs,
    whether the output is partial sums) of one attention layer
    (``_attn_locals``' modes; the joins are all-gathers, so the
    gradient of a joined leaf flows back to its shards)."""
    m = len(pa)
    ck = pa[0]["wk"]["w"].shape[-1]
    mode, locals_ = _attn_locals(pa[0]["wq"]["w"].shape[-1], ck, cfg, m)
    if mode in ("whole", "heads"):
        return pa, locals_, mode == "heads"
    pa = [dict(p) for p in pa]
    if ck != cfg.n_kv_heads * cfg.hd:
        for name in ("wk", "wv"):
            _joined(pa, name, list(range(m)), devices)
    if mode == "shared":
        r = m // cfg.n_heads
        for h in range(cfg.n_heads):
            _joined(pa, "wq", list(range(h * r, (h + 1) * r)), devices)
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


def _attn_block(ps, xs, cfg, devices, attn, name="attn", ln="ln1"):
    """The residuals after one pre-norm attention sublayer over the group
    (``ps[j][name]`` normed by ``ps[j][ln]``). ``attn(p_attn, h, local
    cfg, j)`` is position j's attention through its ``wo`` rows."""
    pa, local, partial = _attn_plan([p[name] for p in ps], cfg, devices)
    hs = [attn(pa[j], norm_apply(ps[j][ln], xs[j]), local[j], j)
          for j in range(len(ps))]
    if partial:
        hs = reduce_sum(hs, devices)
    return [maybe_shard(x + h, "residual") for x, h in zip(xs, hs)]


def _ffn_block(ps, xs, cfg, devices):
    """The residuals after the (MLP | MoE) sublayer, and the MoE's aux
    values or None."""
    normed = [norm_apply(p["ln2"], x) for p, x in zip(ps, xs)]
    if "moe" in ps[0]:
        ys, aux = _moe([p["moe"] for p in ps], normed, cfg, devices)
    else:
        ys, aux = _mlp([p["mlp"] for p in ps], normed, cfg, devices), None
    return [x + y for x, y in zip(xs, ys)], aux


def _layer(ps, xs, cfg, devices, attn):
    """One pre-norm attention + (MLP | MoE) layer over the group (an
    ``attn_mlp``, ``attn_moe``, ``local``, ``shared_attn`` or
    ``enc_attn_mlp`` layer): (the new residuals, one per position; the
    MoE's aux values or None)."""
    return _ffn_block(ps, _attn_block(ps, xs, cfg, devices, attn), cfg,
                      devices)


def _dec_layer(ps, xs, cfg, devices, self_attn, cross_attn):
    """A decoder layer (``dec_attn_mlp``) over the group: the
    self-attention through ``attn``'s plan, the cross-attention through
    ``xattn``'s (its q / k / v columns and ``wo`` rows split as the
    self-attention's are), then the MLP."""
    xs = _attn_block(ps, xs, cfg, devices, self_attn)
    xs = _attn_block(ps, xs, cfg, devices, cross_attn, "xattn", "ln_x")
    return _ffn_block(ps, xs, cfg, devices)[0]


def _zip(shards):
    """The group's stack as one tree whose layers each hold a list of the
    model positions' trees (``params["shared"]`` a list of its copies):
    what ``transformer.stack_layers`` and ``stack_apply_full`` walk for a
    group. A ``shared_attn`` position of ``units`` stays a list of
    ``{}``, as the one-device stack has it."""
    out = {w: tuple(list(ps) for ps in zip(*(s[w] for s in shards)))
           for w in ("head", "units", "tail")}
    if "shared" in shards[0]:
        out["shared"] = [s["shared"] for s in shards]
    return out


def _full_layer(kind, ps, xs, cfg, ctx=None, *, devices):
    """One training layer over the group (``layer_apply_full``'s
    counterpart): (residuals, aux or None). ``ctx`` holds each position's
    encoder output (``enc_out``, a list) and the prefix length, where the
    stack reads them."""
    if kind in RECURRENT_KINDS:
        return tp_recurrent.LAYERS[kind](ps, xs, cfg, devices)[0], None
    if kind == "dec_attn_mlp":
        enc = ctx["enc_out"]
        return _dec_layer(
            ps, xs, cfg, devices,
            lambda p, h, lc, j: blocks.attn_apply_fullseq(p, h, lc),
            lambda p, h, lc, j: blocks.attn_apply_fullseq(
                p, h, lc, cross_kv=blocks.cross_kv(p, enc[j], lc))), None
    mk, window = mask_kind(kind, cfg)
    pl = prefix_len(cfg, ctx)
    return _layer(ps, xs, cfg, devices,
                  lambda p, h, lc, j: blocks.attn_apply_fullseq(
                      p, h, lc, kind=mk, window=window, prefix_len=pl))


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


def _encode(group: Group, cfg, frames: List[torch.Tensor], *, serve: bool):
    """whisper's encoder over the group (``api._encode``'s counterpart):
    frames (P, B, F, D) at each position -> the encoder's output there.
    The sinusoid positions are added at every position; the layers run
    over the group, in training as ``stack_apply_full``'s, in serving
    with each position's heads through #5 bidirectional
    (``attn_apply_encode``). The output, after the replicated final
    norm, holds the same bits at every position."""
    from .api import _enc_cfg, _sinusoid
    devices = group.devices
    enc = [s["encoder"] for s in group.shards]
    enc_cfg = _enc_cfg(cfg)
    xs = [f + _sinusoid(f.shape[2], cfg.d_model, f.dtype, f.device)
          for f in frames]
    if serve:
        for unit in unit_params(_zip(enc), enc_cfg):
            xs, _ = _layer(unit[0], xs, enc_cfg, devices,
                           lambda p, h, lc, j: blocks.attn_apply_encode(
                               p, h, lc))
    else:
        xs, _ = stack_apply_full(_zip(enc), xs, enc_cfg,
                                 layer=functools.partial(_full_layer,
                                                         devices=devices))
    return [norm_apply(e["final_norm"], x) for e, x in zip(enc, xs)]


def _backbone_inputs(group: Group, batch, cfg, *, serve: bool = False):
    """``api._backbone_inputs`` over the group: (the residuals, one per
    position; the ``ctx`` the layers read, its ``enc_out`` a list of each
    position's encoder output; the number of leading positions that are
    not text). The frontend (frames, patches) is shared by the particles
    and placed at every position: whisper's sinusoid positions added
    there, paligemma's patches put in front of the text there."""
    from .api import _dtype, _frontend, _sinusoid
    shards, devices = group.shards, group.devices
    dtype = _dtype(cfg)
    xs = _embed(shards, batch["tokens"], dtype, cfg, devices)
    P = xs[0].shape[0]
    ctx: Dict[str, Any] = {}
    offset = 0
    if cfg.family == "audio":
        frames = [_frontend(batch, "frames", cfg, P, dtype, d)
                  for d in devices]
        ctx["enc_out"] = _encode(group, cfg, frames, serve=serve)
        xs = [x + _sinusoid(x.shape[2], cfg.d_model, dtype, x.device)
              for x in xs]
    elif cfg.family == "vlm":
        xs = [torch.cat([_frontend(batch, "patches", cfg, P, dtype,
                                   x.device), x], 2) for x in xs]
        ctx["prefix_len"] = offset = cfg.n_prefix_tokens
    return xs, ctx, offset


def forward(group, batch, cfg):
    """``api.forward`` over a group: the output on the first position
    (the LM's final-norm hidden states of the text positions and its MoE
    aux values, the ViT's logits)."""
    from . import api
    if not has_split(group):
        return api.forward(entry(group), batch, cfg)
    if cfg.family == "vision":
        return vit_forward(group, batch["images"], cfg), {}
    if cfg.family not in api.LM_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no tensor-parallel forward")
    shards, devices = group.shards, group.devices
    xs, ctx, offset = _backbone_inputs(group, batch, cfg)
    xs, aux = stack_apply_full(_zip(shards), xs, cfg, ctx=ctx,
                               layer=functools.partial(_full_layer,
                                                       devices=devices))
    x = norm_apply(shards[0]["final_norm"], xs[0])
    return (x[:, :, offset:] if offset else x), aux


# --------------------------------------------------------------------------
# serving: the paged pool and the dense caches
# --------------------------------------------------------------------------

def _serve(group: Group, xs, cfg, state: Group, pick, layer):
    """The stack over each position's state (``state``: a Group of page
    pools or dense caches; ``pick`` takes a unit's) and the final norm,
    on the first position. ``layer(kind, ps, xs, sts)`` runs one layer
    over the group (``sts[j]``: position j's state of the layer) and
    returns the new residuals."""
    dt = xs[0].dtype
    for where, kind, ps, sts in stack_layers(
            _zip(group.shards), _zip(state.shards), cfg,
            lambda s, u: [pick(x, u) for x in s]):
        xs = layer(kind, ps, xs, sts)
        if where == "units":
            xs = [x.to(dt) for x in xs]
    return norm_apply(group.shards[0]["final_norm"], xs[0])


def _paged(group: Group, tokens, cfg, pages: Group, ctx, attn):
    """A paged step over the group: ``ctx`` (the step's block tables,
    lengths, write index) moved to every position, ``attn(p, h, lc, st,
    ctx)`` one position's attention over its pool."""
    from .api import _dtype
    devices = group.devices
    ctxs = [_on(ctx, d) for d in devices]
    xs = _embed(group.shards, tokens, _dtype(cfg), cfg, devices)
    return _serve(group, xs, cfg, pages, page_unit,
                  lambda kind, ps, xs, sts: _layer(
                      ps, xs, cfg, devices,
                      lambda p, h, lc, j: attn(p, h, lc, sts[j],
                                               ctxs[j]))[0])


def _paged_attn(p, h, lc, st, ctx):
    return blocks.attn_apply_paged(
        p, h, lc, st, block_tables=ctx["block_tables"],
        seq_lens=ctx["seq_lens"], write_index=ctx["write_index"],
        use_kernel=ctx.get("decode_kernel", True))[0]


def _window_attn(p, h, lc, st, ctx):
    return blocks.attn_apply_window_paged(
        p, h, lc, st, block_tables=ctx["block_tables"],
        seq_lens=ctx["seq_lens"], write_index=ctx["write_index"])[0]


def _prefill_paged_attn(p, h, lc, st, ctx):
    return blocks.attn_apply_prefill_paged(
        p, h, lc, st, write_index=ctx["write_index"])[0]


def decode_step_paged(group, tokens, pages, ctx, cfg):
    """``api.decode_step_paged`` over a group (``ctx`` built there)."""
    paged_guard(cfg)
    x = _paged(group, tokens.clamp(min=0)[:, None], cfg, pages, ctx,
               _paged_attn)
    return logits(group, x, cfg)[:, :, 0], pages


def decode_window_paged(group, tokens, pages, ctx, cfg):
    """``api.decode_window_paged`` over a group."""
    paged_guard(cfg)
    x = _paged(group, tokens.clamp(min=0), cfg, pages, ctx, _window_attn)
    return logits(group, x, cfg), pages


def prefill_paged(group, tokens, pages, ctx, n_tokens, cfg):
    """``api.prefill_paged`` over a group."""
    paged_guard(cfg)
    x = _paged(group, tokens, cfg, pages, ctx, _prefill_paged_attn)
    last = (n_tokens.long() - 1).clamp(min=0).reshape(1)
    return logits(group, x.index_select(2, last)[:, :, 0], cfg), pages


def _write_all(sts, new):
    for st, n in zip(sts, new):
        _write_state(st, n)


def _prefill_layer(kind, ps, xs, sts, *, cfg, devices, ctx):
    """One layer of the dense prefill over the group: it fills each
    position's empty cache (``layer_apply_prefill``'s counterpart)."""
    if kind in RECURRENT_KINDS:
        xs, new = tp_recurrent.LAYERS[kind](ps, xs, cfg, devices)
        _write_all(sts, new)
        return xs
    if kind == "dec_attn_mlp":
        enc = ctx["enc_out"]

        def cross(p, h, lc, j):
            kv = blocks.cross_kv(p, enc[j], lc)
            _write_state(sts[j], {"xk": kv[0], "xv": kv[1]})
            return blocks.attn_apply_fullseq(p, h, lc, cross_kv=kv)

        return _dec_layer(ps, xs, cfg, devices,
                          lambda p, h, lc, j: blocks.attn_apply_prefill(
                              p, h, lc, sts[j]["self"])[0], cross)
    w, pl = window_of(kind, cfg), prefix_len(cfg, ctx)
    return _layer(ps, xs, cfg, devices,
                  lambda p, h, lc, j: blocks.attn_apply_prefill(
                      p, h, lc, sts[j], window=w, prefix_len=pl)[0])[0]


def _decode_layer(kind, ps, xs, sts, *, cfg, devices, curs):
    """One layer of the dense decode step over the group, each position's
    cache or state updated in place (``layer_apply_decode``'s
    counterpart)."""
    if kind in RECURRENT_KINDS:
        xs, new = tp_recurrent.LAYERS[kind](ps, xs, cfg, devices, sts)
        _write_all(sts, new)
        return xs
    if kind == "dec_attn_mlp":
        return _dec_layer(ps, xs, cfg, devices,
                          lambda p, h, lc, j: blocks.attn_apply_decode(
                              p, h, lc, sts[j]["self"], cur_pos=curs[j])[0],
                          lambda p, h, lc, j: blocks.cross_attn_decode(
                              p, h, lc, sts[j]["xk"], sts[j]["xv"]))
    w = window_of(kind, cfg)
    return _layer(ps, xs, cfg, devices,
                  lambda p, h, lc, j: blocks.attn_apply_decode(
                      p, h, lc, sts[j], cur_pos=curs[j], window=w)[0])[0]


def cache_init(group: Group, cfg, particles: int, batch: int, C: int, *,
               dtype) -> Group:
    """Empty dense caches and recurrent states for a group
    (``transformer.stack_cache_init``'s tree at each position): an
    attention layer's cache holds the kv heads its position reads (its
    own, or every kv head where the axis does not divide them), a decoder
    layer's cross k / v its ``xattn``'s; a recurrent layer's state its
    position's heads (``tp_recurrent``)."""
    m = len(group)
    out = []
    for j, (s, d) in enumerate(zip(group.shards, group.devices)):
        def one(kind, p, lead=()):
            if kind in RECURRENT_KINDS:
                return tp_recurrent.STATE_INIT[kind](
                    p, cfg, m, particles, batch, dtype=dtype, device=d,
                    lead=lead)
            lc = _attn_local(p["attn"], cfg, m, j)
            cache = blocks.attn_cache_init(lc, particles, batch, C,
                                           dtype=dtype, device=d, lead=lead,
                                           window=window_of(kind, cfg))
            if kind != "dec_attn_mlp":
                return cache
            xl = _attn_local(p["xattn"], cfg, m, j)
            shape = (particles,) + tuple(lead) + (batch, cfg.n_frames,
                                                  xl.n_kv_heads, xl.hd)
            return {"self": cache,
                    "xk": torch.zeros(shape, dtype=dtype, device=d),
                    "xv": torch.zeros(shape, dtype=dtype, device=d)}

        out.append({
            "head": tuple(one(k, p) for k, p in zip(cfg.head_layers,
                                                     s["head"])),
            "units": tuple(one(k, s["shared"] if k == "shared_attn" else p,
                               (cfg.n_units,))
                           for k, p in zip(cfg.pattern, s["units"])),
            "tail": tuple(one(k, p) for k, p in zip(cfg.tail_layers,
                                                     s["tail"]))})
    return Group(out, None, group.devices)


def _attn_local(pa, cfg, m: int, j: int):
    """Position j's local config of an attention layer (its params
    ``pa``)."""
    return _attn_locals(pa["wq"]["w"].shape[-1], pa["wk"]["w"].shape[-1],
                        cfg, m)[1][j]


def prefill(group: Group, batch, cfg, C: int):
    """``api.prefill`` over a group (``batch`` its tokens on the first
    position, and the frontend where the family has one): the last
    token's logits and each position's dense caches and states
    (``cache_init``)."""
    from .api import _cache_dtype
    decode_guard(cfg)
    B = batch["tokens"].shape[0]
    caches = cache_init(group, cfg, group.shards[0]["embed"].shape[0], B, C,
                        dtype=_cache_dtype(cfg))
    xs, ctx, _ = _backbone_inputs(group, batch, cfg, serve=True)
    if cfg.family == "audio" and ctx["enc_out"][0].shape[2] != cfg.n_frames:
        raise ValueError(f"frames hold {ctx['enc_out'][0].shape[2]} "
                         f"positions; the cache holds cfg.n_frames = "
                         f"{cfg.n_frames}")
    x = _serve(group, xs, cfg, caches, cache_unit, functools.partial(
        _prefill_layer, cfg=cfg, devices=group.devices, ctx=ctx))
    return logits(group, x[:, :, -1:], cfg)[:, :, 0], caches


def decode_step(group: Group, token, caches: Group, cur_pos, cfg):
    """``api.decode_step`` over a group (``cur_pos`` a 0-d device tensor,
    checked by the caller); whisper's sinusoid position of ``cur_pos`` is
    added at every position."""
    from .api import _dtype, _sinusoid
    decode_guard(cfg)
    devices = group.devices
    curs = [cur_pos.to(d) for d in devices]
    xs = _embed(group.shards, token.clamp(min=0)[:, None], _dtype(cfg), cfg,
                devices)
    if cfg.family == "audio":
        xs = [x + _sinusoid(1, cfg.d_model, x.dtype, x.device, start=c)
              for x, c in zip(xs, curs)]
    x = _serve(group, xs, cfg, caches, cache_unit, functools.partial(
        _decode_layer, cfg=cfg, devices=devices, curs=curs))
    return logits(group, x, cfg)[:, :, 0], caches
