"""Model facade (counterpart of ``repro.models.api``): the LMs' serving
entry points (paged continuous-batching prefill, decode and speculative
verify window; prefill into and decode over a dense cache and recurrent
state) and the training forward and loss of every family: the dense and
MoE LMs (token cross-entropy in sequence chunks; MoE adds its router's
aux losses), the recurrent LMs "ssm" (RWKV6) and "hybrid" (Mamba2 with
zamba2's shared attention), the encoder-decoder "audio" (whisper: an
encoder over the stub frames, sinusoid positions on top of RoPE, a
decoder that cross-attends to it) and the prefix-LM "vlm" (paligemma:
the stub patches in front of the text, seen bidirectionally; the loss
and the logits drop them), which serve from the dense path only, as in
the reference, the vision family (ViT) and the pde family (the 1-D
UNet).

``init_params`` builds ONE particle's tree (no particle axis); the store
stacks particles. Every other function takes the stacked tree with a
leading particle axis ``P`` and returns per-particle outputs ``(P, ...)``.
Batches carry no particle axis: every particle sees the same batch.

Under a model axis (a 2D placement) the stacked tree arrives as a
``core.tree.Group`` of model shards: ``forward`` and the serving entry
points hand it to their tensor-parallel counterparts in ``models.tp``,
and ``loss_fn`` takes the same loss on what ``tp.forward`` returns.

LM batches (families "dense", "moe", "ssm" and "hybrid"): ``{"tokens":
(B, S) int, "labels": (B, S) int}`` (labels < 0 masked); audio batches
add ``"frames": (B, n_frames, D) f32`` and vlm batches ``"patches": (B,
n_prefix_tokens, D) f32`` (``data.synthetic.frontend_stub``), shared by
the particles, as the tokens are; vision batches:
``{"images": (B, 28, 28, 1) f32, "labels": (B,) int}``; pde batches:
``{"u0": (B, L, 1) f32, "u1": (B, L, 1) f32}``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as _ckpt

from ..core.precision import tree_bytes
from ..core.tree import Group
from ..runtime.program import host_check
from ..sharding.policy import maybe_shard
from .blocks import (dense_init, norm_apply, norm_init, paged_write_index,
                     prefill_write_index, window_write_index)
from .transformer import (RECURRENT_KINDS, decode_guard, layer_apply_encode,
                          paged_guard, stack_apply_decode, stack_apply_full,
                          stack_apply_paged, stack_apply_prefill,
                          stack_apply_prefill_paged,
                          stack_apply_window_paged, stack_cache_init,
                          stack_init, stack_paged_init, unit_params)
from . import tp
from . import unet1d as unet_mod
from . import vit as vit_mod

LOSS_CHUNK = 512
LM_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


def init_params(gen, cfg):
    """One particle's params, drawn from ``gen`` on ``gen.device``."""
    if cfg.family == "vision":
        return vit_mod.vit_init(gen, cfg)
    if cfg.family == "pde":
        return unet_mod.unet_init(gen, cfg)
    params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=gen.device) * 0.02,
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=gen.device),
        **stack_init(gen, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
    if cfg.is_encoder_decoder:
        params["encoder"] = {**stack_init(gen, _enc_cfg(cfg)),
                             "final_norm": norm_init(cfg.norm, cfg.d_model,
                                                     device=gen.device)}
    return params


def _enc_cfg(cfg):
    """The encoder stack's config: ``n_encoder_layers`` units of
    ``enc_attn_mlp``."""
    return cfg.replace(pattern=("enc_attn_mlp",), n_units=cfg.n_encoder_layers,
                       head_layers=(), tail_layers=())


def _sinusoid(S: int, D: int, dtype, device, start=0):
    """Sinusoid positions start..start+S-1 (S, D): sin over the first D/2
    dims, cos over the rest, as the reference's; ``start`` may be a 0-d
    device tensor (a decode step's position)."""
    pos = (torch.arange(S, dtype=torch.float32, device=device)
           + start)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _frontend(batch, key, cfg, P, dtype, device):
    """The batch's stub frontend embeddings (B, L, D) -> (P, B, L, D) in
    ``dtype``, shared by the particles."""
    if batch.get(key) is None:
        raise ValueError(f"family {cfg.family!r} needs {key!r} in the batch "
                         f"(data.synthetic.make_batch)")
    t = torch.as_tensor(batch[key]).to(device=device, dtype=dtype)
    return t.expand(P, *t.shape)


def _encode(params, frames, cfg, *, serve=False):
    """whisper's encoder over the frames (P, B, F, D): sinusoid positions
    added, ``n_encoder_layers`` bidirectional layers, the final norm. In
    training (``serve`` False) the layers are the differentiable
    ``stack_apply_full``'s; in serving each layer's attention runs
    through the prefill kernel (``layer_apply_encode``)."""
    if "encoder" not in params:
        raise ValueError(f"family {cfg.family!r} needs an encoder: "
                         f"cfg.is_encoder_decoder with n_encoder_layers")
    enc, enc_cfg = params["encoder"], _enc_cfg(cfg)
    x = frames + _sinusoid(frames.shape[2], cfg.d_model, frames.dtype,
                           frames.device)
    if serve:
        for unit in unit_params(enc, enc_cfg):
            x = layer_apply_encode(unit[0], x, enc_cfg)
    else:
        x = stack_apply_full(enc, x, enc_cfg)[0]
    return norm_apply(enc["final_norm"], x)


def _backbone_inputs(params, batch, cfg, dtype, *, serve=False):
    """The stack's input x (P, B, S, D), the ``ctx`` its layers read and
    the number of leading positions that are not text: the token
    embeddings; for the audio family plus sinusoid positions, with the
    encoder's output in ``ctx["enc_out"]``; for the vlm family after the
    patches, with ``ctx["prefix_len"]`` and the offset their count."""
    x = _embed(params, torch.as_tensor(batch["tokens"]).to(
        params["embed"].device), dtype)
    P, device = x.shape[0], x.device
    ctx: Dict[str, Any] = {}
    offset = 0
    if cfg.family == "audio":
        frames = _frontend(batch, "frames", cfg, P, dtype, device)
        ctx["enc_out"] = _encode(params, frames, cfg, serve=serve)
        x = x + _sinusoid(x.shape[2], cfg.d_model, dtype, device)
    elif cfg.family == "vlm":
        patches = _frontend(batch, "patches", cfg, P, dtype, device)
        x = torch.cat([patches, x], 2)
        ctx["prefix_len"] = offset = cfg.n_prefix_tokens
    return x, ctx, offset


def _ce_chunk(params, xi, li, cfg):
    """One loss chunk: per-particle sums of (lse - gold) over the live
    labels (P,), and the count of live labels."""
    logits = _lm_logits(params, xi, cfg).float()            # (P, B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    idx = li.clamp(min=0).long()
    gold = logits.gather(-1, idx.expand(logits.shape[:3])[..., None])[..., 0]
    mask = (li >= 0).float()
    return ((lse - gold) * mask).sum((1, 2)), mask.sum()


def _chunked_ce(params, x, labels, cfg):
    """Cross-entropy over sequence chunks of LOSS_CHUNK, per particle
    (P,); never a full (P, B, S, V) tensor. Each chunk's head and
    log-sum-exp run under a checkpoint, as the reference's
    ``jax.checkpoint`` does, so the backward recomputes the chunk's
    logits instead of keeping every chunk's. Labels < 0 are masked."""
    P, B, S, D = x.shape
    C = min(LOSS_CHUNK, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = cnt = 0.0
    for i in range(n):
        cols = slice(i * C, (i + 1) * C)
        l, m = _ckpt.checkpoint(_ce_chunk, params, x[:, :, cols],
                                labels[:, cols], cfg, use_reentrant=False,
                                preserve_rng_state=False)
        tot, cnt = tot + l, cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def forward(params, batch, cfg):
    """Training-style full forward. Returns (per-particle output, aux):
    the final-norm hidden states (P, B, S, D) of the text positions for
    the LM families (the vlm's patches dropped; ``loss_fn`` applies the
    head chunk by chunk), logits (P, B,
    n_classes) for the vision family, the predicted next state (P, B, L,
    1) for the pde family. aux holds the MoE layers' summed aux values
    (``lb_loss``, ``z_loss``, ``dropped_frac``, each (P,)); it is {} for
    a stack with no MoE layer and for the other families."""
    if isinstance(params, Group):
        return tp.forward(params, batch, cfg)
    if cfg.family == "vision":
        return vit_mod.vit_apply(params, batch["images"], cfg), {}
    if cfg.family == "pde":
        return unet_mod.unet_apply(params, batch["u0"], cfg), {}
    x, ctx, offset = _backbone_inputs(params, batch, cfg, _dtype(cfg))
    x, aux = stack_apply_full(params, x, cfg, ctx=ctx)
    x = norm_apply(params["final_norm"], x)
    return (x[:, :, offset:] if offset else x), aux


def loss_fn(params, batch, cfg):
    """Returns (loss (P,), metrics), one value per particle: the token
    cross-entropy over the live labels (the LM families; with experts,
    plus ``router_aux_coef * (lb_loss + z_loss)``, and the metrics carry
    the three aux values), the class cross-entropy and accuracy averaged
    over the batch (vision), or the squared error against ``u1``
    averaged over (B, L, 1) (pde)."""
    out, aux = forward(params, batch, cfg)
    if cfg.family in LM_FAMILIES:
        loss = _chunked_ce(params, out, batch["labels"], cfg)
        metrics = {"loss": loss}
        if cfg.n_experts:
            loss = loss + cfg.router_aux_coef * (aux["lb_loss"]
                                                 + aux["z_loss"])
            metrics.update(aux)
        return loss, metrics
    if cfg.family == "pde":
        loss = (out - batch["u1"]).square().flatten(1).mean(-1)
        return loss, {"loss": loss}
    logits = out.float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)                       # (P, B)
    gold = logits.gather(-1, labels.expand(logits.shape[:2])[..., None])
    loss = (lse - gold[..., 0]).mean(-1)
    acc = (logits.argmax(-1) == labels).float().mean(-1)
    return loss, {"loss": loss, "acc": acc}


def param_footprint(cfg, precision=None) -> int:
    """One particle's parameter bytes under a precision policy: floating
    leaves at the policy's master itemsize (``core.precision.tree_bytes``),
    from an init traced under a fake-tensor mode (shapes only: no memory,
    no random numbers drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init_params(torch.Generator(), cfg)
    return tree_bytes(tree, precision)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _cache_dtype(cfg):
    return torch.bfloat16 if _dtype(cfg) == torch.bfloat16 else torch.float32


def _embed(params, tokens, dtype):
    """tokens (B, S) -> (P, B, S, D): the rows are gathered, then cast (the
    same values as casting the table first, without writing a cast copy
    of the whole table when it is stored in another dtype)."""
    return maybe_shard(params["embed"][:, tokens.long()].to(dtype),
                       "residual")


def _lm_logits(params, x, cfg):
    """x (P, ..., D) -> (P, ..., V); the tied head is x @ embed.T (over a
    model group, ``tp.logits``)."""
    if isinstance(params, Group):
        return tp.logits(params, x, cfg)
    w = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
         else params["lm_head"]["w"]).to(x.dtype)
    P, D = x.shape[0], x.shape[-1]
    return maybe_shard(torch.bmm(x.reshape(P, -1, D), w).reshape(
        *x.shape[:-1], w.shape[-1]), "logits")


def prefill(params, batch, cfg, max_len=None):
    """Full-prompt pass that builds the dense decode caches.

    batch {"tokens": (B, S) int} (plus the audio family's "frames", the
    vlm family's "patches"); every particle sees the same batch. The
    vlm's sequence is its patches and then its tokens, S_all = n_prefix
    + S positions; the others' S_all = S. ``max_len`` allocates decode
    headroom in the caches and counts every position (defaults to S_all;
    pass S_all + decode budget + 1 for generation). Returns (last-token
    logits (P, B, V), caches): per attention layer k/v (P, B, max_len,
    KVH, hd) and pos (B, max_len) int32, shared by the particles; per
    decoder layer also the encoder's cross k / v (P, B, n_frames, KVH,
    hd); per recurrent layer its scan's final state
    (``stack_cache_init``)."""
    device = (params.devices[0] if isinstance(params, Group)
              else params["embed"].device)
    tokens = torch.as_tensor(batch["tokens"]).to(device)
    B, S = tokens.shape
    S_all = S + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    C = S_all if max_len is None else max_len
    if C < S_all:
        raise ValueError(f"max_len {C} < prompt length {S_all}")
    if isinstance(params, Group):
        return tp.prefill(params, {**batch, "tokens": tokens}, cfg, C)
    caches = stack_cache_init(cfg, params["embed"].shape[0], B, C,
                              dtype=_cache_dtype(cfg), device=tokens.device)
    x, ctx, _ = _backbone_inputs(params, {**batch, "tokens": tokens}, cfg,
                                 _dtype(cfg), serve=True)
    if cfg.family == "audio" and ctx["enc_out"].shape[2] != cfg.n_frames:
        raise ValueError(f"frames hold {ctx['enc_out'].shape[2]} positions; "
                         f"the cache holds cfg.n_frames = {cfg.n_frames}")
    x, caches = stack_apply_prefill(params, x, cfg, caches, ctx)
    x = norm_apply(params["final_norm"], x[:, :, -1:])
    return _lm_logits(params, x, cfg)[:, :, 0], caches


def decode_step(params, token, caches, cur_pos, cfg):
    """One decode step over the dense caches for every particle.

    token (B,) int; cur_pos: the absolute position of every row's token,
    an int or a 0-d int tensor, never read on the host. A position outside
    the cache raises ValueError: an int is checked here, a captured step's
    tensor through ``runtime.program.host_check`` on the int it is filled
    from before each replay; any other tensor is its caller's to check.
    The caches are updated in place. The audio family adds the sinusoid
    position of ``cur_pos`` to the token's embedding; the vlm's positions
    count its patches. Returns (logits (P, B, V), caches)."""
    decode_guard(cfg)
    check = functools.partial(_check_cur_pos, C=_global_len(caches, cfg))
    if isinstance(cur_pos, torch.Tensor):
        host_check(cur_pos, check)
    else:
        check(cur_pos)
        cur_pos = torch.tensor(cur_pos, device=token.device)
    if isinstance(params, Group):
        return tp.decode_step(params, token, caches, cur_pos, cfg)
    x = _embed(params, token.clamp(min=0)[:, None], _dtype(cfg))
    if cfg.family == "audio":
        x = x + _sinusoid(1, cfg.d_model, x.dtype, x.device, start=cur_pos)
    ctx: Dict[str, Any] = {"cur_pos": cur_pos}
    x, caches = stack_apply_decode(params, x, cfg, caches, ctx)
    x = norm_apply(params["final_norm"], x)
    return _lm_logits(params, x, cfg)[:, :, 0], caches


def _global_len(caches, cfg):
    """The slots of the stack's global (non-ring) caches: the positions a
    decode may reach; None when no layer has one (``local`` rings and
    recurrent states: any position is then in range)."""
    tree = caches.shards[0] if isinstance(caches, Group) else caches
    kinds = {"head": cfg.head_layers, "units": cfg.pattern,
             "tail": cfg.tail_layers}
    for group in ("units", "head", "tail"):
        for kind, c in zip(kinds[group], tree[group]):
            if kind not in ("local",) + RECURRENT_KINDS:
                return c.get("self", c)["k"].shape[-3]
    return None


def _check_cur_pos(cur_pos, C):
    if int(cur_pos) < 0 or (C is not None and int(cur_pos) >= C):
        raise ValueError(f"cur_pos {int(cur_pos)} is outside the cache of "
                         f"{C} slots")


def init_cache(cfg, batch: int, seq_len: int, *, particles: int,
               dtype=None, device=None):
    """Empty dense caches for ``particles`` stacked particles (the tree
    ``prefill`` returns), on ``cuda`` unless ``device`` says otherwise."""
    return stack_cache_init(cfg, particles, batch, seq_len,
                            dtype=dtype or _cache_dtype(cfg),
                            device=torch.device("cuda") if device is None
                            else device)


def paged_cache_init(cfg, *, num_pages: int, page_size: int, dtype=None,
                     device=None):
    """One particle's KV page pool: a (num_pages + 1, page_size, KVH, hd)
    k/v pair per attention layer. Block tables name pages 0..num_pages-1
    and live with the scheduler; the extra page is the scratch page
    (``scratch_page``)."""
    return stack_paged_init(cfg, num_pages + 1, page_size,
                            dtype=dtype or _cache_dtype(cfg),
                            device=torch.device("cuda") if device is None
                            else device)


def decode_step_paged(params, tokens, pages, block_tables, seq_lens, cfg, *,
                      decode_kernel: bool = True):
    """One continuous-batching decode step for every particle.

    tokens (B,) int (garbage ok on inactive rows); block_tables
    (B, n_pmax) int32; seq_lens (B,) int32 absolute position of each token
    (-1 = inactive row: no pool writes, logits garbage — mask downstream).
    ``pages`` is a ``paged_cache_init`` pool: no block table may name its
    ``scratch_page``. Pages are updated in place. Returns
    (logits (P, B, V), pages).
    ``decode_kernel=False`` takes the plain attention on any device, for
    parity checks against the kernel; ``serve_decode`` never sets it."""
    paged_guard(cfg)
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    x = (None if isinstance(params, Group) else
         _embed(params, tokens.clamp(min=0)[:, None], _dtype(cfg)))
    ctx: Dict[str, Any] = {
        "block_tables": block_tables, "seq_lens": seq_lens,
        "write_index": paged_write_index(block_tables, seq_lens,
                                         _page_size(pages),
                                         scratch_page(pages)),
        "decode_kernel": decode_kernel}
    if isinstance(params, Group):
        return tp.decode_step_paged(params, tokens, pages, ctx, cfg)
    x, pages = stack_apply_paged(params, x, cfg, pages, ctx)
    x = norm_apply(params["final_norm"], x)
    return _lm_logits(params, x, cfg)[:, :, 0], pages


def decode_window_paged(params, tokens, pages, block_tables, seq_lens,
                        win_lens, cfg):
    """Speculative verify: score a W-token drafted window in one pass.

    tokens (B, W) int: token w of row b sits at absolute position
    ``seq_lens[b] + w`` (window token 0 is the last committed token, the
    rest are drafts); win_lens (B,) int32, the real window tokens per row
    (positions past it are padding: not written to the pool, logits
    garbage — mask downstream); seq_lens (B,) int32 (-1 = inactive row).
    Pages are updated in place. Returns (logits (P, B, W, V), pages);
    logits[:, :, w] predicts the token AFTER window position w."""
    paged_guard(cfg)
    block_tables = block_tables.contiguous()
    seq_lens = seq_lens.contiguous()
    W = tokens.shape[1]
    ctx: Dict[str, Any] = {
        "block_tables": block_tables, "seq_lens": seq_lens,
        "write_index": window_write_index(block_tables, seq_lens, win_lens,
                                          W, _page_size(pages),
                                          scratch_page(pages))}
    if isinstance(params, Group):
        return tp.decode_window_paged(params, tokens, pages, ctx, cfg)
    x = _embed(params, tokens.clamp(min=0), _dtype(cfg))
    x, pages = stack_apply_window_paged(params, x, cfg, pages, ctx)
    x = norm_apply(params["final_norm"], x)
    return _lm_logits(params, x, cfg), pages


def prefill_paged(params, tokens, pages, block_table_row, n_tokens, cfg):
    """Prompt prefill for ONE sequence into the page pool.

    tokens (1, Sp) int padded to a shape bucket; block_table_row
    (n_pmax,) int32; n_tokens: count of real tokens, a 0-d device tensor
    (as the reference traces it) or an int, never read on the host. All
    Sp positions are written: the padding's go to the scratch page.
    Returns (last-real-token logits (P, 1, V), pages)."""
    paged_guard(cfg)
    n_tokens = torch.as_tensor(n_tokens, device=tokens.device)
    ctx: Dict[str, Any] = {
        "write_index": prefill_write_index(block_table_row, n_tokens,
                                           tokens.shape[1], _page_size(pages),
                                           scratch_page(pages))}
    if isinstance(params, Group):
        return tp.prefill_paged(params, tokens, pages, ctx, n_tokens, cfg)
    x = _embed(params, tokens, _dtype(cfg))
    x, pages = stack_apply_prefill_paged(params, x, cfg, pages, ctx)
    x = norm_apply(params["final_norm"], x)
    last = (n_tokens.long() - 1).clamp(min=0).reshape(1)
    last = x.index_select(2, last)[:, :, 0]                 # (P, 1, D)
    return _lm_logits(params, last, cfg), pages


def _first_kv(tree):
    """The k leaf of the first attention layer of a page or cache tree
    (its first model shard's, for a Group)."""
    if isinstance(tree, Group):
        tree = tree.shards[0]
    for group in ("units", "head", "tail"):
        if tree[group]:
            return tree[group][0]["k"]
    raise ValueError("the tree holds no attention layer")


def _page_size(pages) -> int:
    return _first_kv(pages).shape[-3]


def scratch_page(pages) -> int:
    """The index of the scratch page of a ``paged_cache_init`` pool (its
    last page, one past the ``num_pages`` it was made for): it takes the
    KV writes the reference drops (``blocks.paged_write_index``), and no
    block table names it, so no kernel reads it."""
    return _first_kv(pages).shape[-4] - 1
