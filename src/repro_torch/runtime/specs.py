"""Step builders over an explicit leading particle axis (counterpart of
``repro.runtime.specs``).

The reference wraps a per-particle function in a vmapped, donated
ProgramSpec that its ProgramCache compiles; here the model functions
already take the stacked particle axis, so a body needs no vmap.

Training: ``ensemble_step``, ``ensemble_predict`` and ``map_step``
(the SWAG collection; ``bdl.svgd.svgd_step_spec`` lives beside its math)
return ``ProgramSpec``s. Their bodies (``core.functional``) update the
stacked state in place and return the caller's own trees, so a captured
train step replays on the store's tensors; the batch and the active mask
are copied into the program's static inputs on each call.

Serving: ``paged_decode_step``, ``paged_prefill``, ``spec_draft_step``,
``spec_verify``, ``bma_step`` (the stateful dense-cache step) and
``bma_predict`` (the stateless BMA forward of one batch bucket) return
``ProgramSpec``s that a ``ProgramCache`` captures once as a CUDA graph
and replays. Each body unpacks the step input, runs the model over all
particles at once and reduces with ``reduce_fn(member_logits (P, B, [W,]
V), mask)``. The params and the page pool (or the dense caches) are read
and updated in place; ``packed`` is the scheduler's one int32 staging
buffer, copied into the program's static input (one host-to-device copy
per call). No body reads a device value on the host.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core import functional
from ..core import precision as precision_mod
from ..core.tree import Group, tree_map
from .program import ProgramSpec, ident


def ensemble_step(loss_fn: Callable, optimizer,
                  precision=None) -> ProgramSpec:
    """One train step for all particles: ``fused(stacked_params,
    stacked_opt_state, batch, mask) -> (stacked_params, stacked_opt_state,
    losses)``, the params and optimizer state updated in place (the
    reference donates them).

    ``precision`` (None, a preset name or a ``Precision``) selects the
    master/compute split: when the compute dtype differs from the
    masters', the body casts the masters and the batch's floats to it,
    the grads come back in the masters' dtype and the update applies to
    the masters (``core.functional.ensemble_step``). Such a spec carries
    ``Precision.key()`` (the cache keys on it); the fp32 spec carries
    None, as the reference's does."""
    prec = precision_mod.get(precision)
    cd = prec.compute if prec.casts_compute else None
    return ProgramSpec(
        name="ensemble_step",
        key=("ensemble_step", ident(loss_fn), ident(optimizer)),
        make=lambda ctx: functional.ensemble_step(loss_fn, optimizer, cd),
        in_kinds=("state", "state", "replicated", "vector"),
        out_kinds=("in:0", "in:1", "vector"),
        precision=prec.key() if prec.casts_compute else None)


def ensemble_predict(forward: Callable) -> ProgramSpec:
    """hat f(x) = (1/n) sum_i nn_{theta_i}(x): ``fused(stacked_params,
    batch, mask)``, mask-weighted over live slots."""
    def members(ctx):
        from ..models import tp

        def fwd(stacked_params, batch):
            with torch.no_grad():
                return (forward(tp.entry(stacked_params), batch),)
        return fwd

    key = ("ensemble_predict", ident(forward))
    return ProgramSpec(
        name="ensemble_predict", key=key,
        make=lambda ctx: functional.ensemble_predict(forward),
        in_kinds=("state", "replicated", "vector"),
        split=_split(key, members, lambda ctx: functional.masked_mean,
                     ("state", "replicated"), ("replicated",), "vector"))


def _split(key, members, combine, in_kinds, out_kinds, mask_kind,
           precision=None):
    """The (members, combine) pair of a reducing spec (``ProgramSpec.
    split``): ``members`` builds the per-position body over every argument
    but the mask, returning (member outputs, *in-place outputs);
    ``combine`` builds ``(gathered member outputs, mask) -> result``."""
    return (ProgramSpec(name=f"{key[0]}.members", key=key + ("members",),
                        make=members, in_kinds=in_kinds,
                        out_kinds=out_kinds, precision=precision),
            ProgramSpec(name=f"{key[0]}.combine", key=key + ("combine",),
                        make=combine, in_kinds=("rows", mask_kind),
                        precision=precision))


def _paged_split(key, body, reduce_fn):
    """The split of a paged serving step: ``body(params, pages, packed) ->
    (member logits, pages)`` at every position, the heads from the
    gathered logits on the first."""
    return _split(key, lambda ctx: body,
                  lambda ctx: lambda logits, mask: reduce_fn(logits, mask),
                  ("state", "state", "replicated"), ("replicated", "in:1"),
                  "replicated")


def map_step(fn: Callable, *, key: Tuple, n_state: int = 1,
             masked: bool = False) -> ProgramSpec:
    """A map over ``n_state`` stacked trees (the SWAG moment collection):
    ``fn(*stacked_trees)`` or, with ``masked=True``, ``fn(*stacked_trees,
    mask)`` updates the first tree in place and returns it. ``fn`` takes
    the whole particle axis and the mask itself (the reference vmaps a
    per-particle ``fn``; a CUDA launch cannot be vmapped), and keeps dead
    slots bit for bit. ``key`` must be stable across calls. Over model
    groups (``core.tree.Group``) ``fn`` runs on each model shard
    (``functional.per_shard``): the map is elementwise, so a replicated
    leaf's copies stay bit-equal."""
    def make(ctx):
        def fused(*args):
            if not isinstance(args[0], Group):
                return (fn(*args),)
            trees = args if not masked else args[:-1]
            mask = args[-1] if masked else None
            for part in functional.per_shard(*trees, mask):
                fn(*(part if masked else part[:-1]))
            return (args[0],)

        return fused

    return ProgramSpec(
        name="map_step",
        key=("map_step",) + (("masked",) if masked else ()) + tuple(key),
        make=make,
        in_kinds=("state",) * n_state + (("vector",) if masked else ()),
        out_kinds=("in:0",))


def paged_decode_step(decode_fn: Callable, reduce_fn: Callable, *,
                      key: Tuple = ()) -> ProgramSpec:
    """One fixed-shape continuous-batching decode step: ``fused(
    stacked_params, pages, packed, mask) -> (heads, pages)``.

    ``decode_fn(params, pages, tokens, block_tables, seq_lens) ->
    (logits (P, B, V), pages)``; ``packed`` is ``(B, 2 + n_pmax)`` int32:
    ``[:, 0]`` tokens, ``[:, 1]`` seq_lens, ``[:, 2:]`` block tables."""
    def members(stacked_params, pages, packed):
        tokens, seq_lens, bt = packed[:, 0], packed[:, 1], packed[:, 2:]
        return decode_fn(stacked_params, pages, tokens, bt, seq_lens)

    def make(ctx):
        def fused(stacked_params, pages, packed, mask):
            logits, pages = members(stacked_params, pages, packed)
            return reduce_fn(logits, mask), pages

        return fused

    key = ("paged_decode_step",) + tuple(key)
    return ProgramSpec(
        name="paged_decode_step", key=key,
        make=make, in_kinds=("state", "state", "replicated", "replicated"),
        out_kinds=("replicated", "in:1"),
        split=_paged_split(key, members, reduce_fn))


def paged_prefill(prefill_fn: Callable, reduce_fn: Callable, *,
                  n_pmax: int, key: Tuple = ()) -> ProgramSpec:
    """Prompt admission of ONE sequence: ``fused(stacked_params, pages,
    packed, mask) -> (heads, pages)``.

    ``prefill_fn(params, pages, tokens (1, Sp), block_table_row, n_tokens)
    -> (last-token logits (P, 1, V), pages)``; ``packed`` is ``(Sp + n_pmax
    + 1,)`` int32: ``[tokens..., block_table..., n_tokens]``. ``n_tokens``
    stays a device scalar, so one program serves every prompt of a bucket
    (one program per pow2 bucket Sp)."""
    def members(stacked_params, pages, packed):
        sp = packed.shape[0] - n_pmax - 1
        tokens = packed[None, :sp]
        bt_row = packed[sp:sp + n_pmax]
        return prefill_fn(stacked_params, pages, tokens, bt_row, packed[-1])

    def make(ctx):
        def fused(stacked_params, pages, packed, mask):
            logits, pages = members(stacked_params, pages, packed)
            return reduce_fn(logits, mask), pages

        return fused

    key = ("paged_prefill", n_pmax) + tuple(key)
    return ProgramSpec(
        name="paged_prefill", key=key,
        make=make, in_kinds=("state", "state", "replicated", "replicated"),
        out_kinds=("replicated", "in:1"),
        split=_paged_split(key, members, reduce_fn))


def spec_draft_step(decode_fn: Callable, *, slot: int, n_iter: int,
                    key: Tuple = (), quantized: bool = False) -> ProgramSpec:
    """Draft tokens from ONE particle: ``fused(stacked_params, pages,
    packed) -> (drafts (B, n_iter) int32, pages)``.

    The single-token decode runs ``n_iter`` times over a one-particle
    view (``a[slot:slot+1]``, taken inside the body) of the params and the
    pages, the argmax of each iteration fed back as the next token. The
    views share storage with the stacked tensors, so the draft's KV writes
    land in the pool itself. The draft slot and the iteration count are
    host ints, so each ``(slot, n_iter)`` is a spec of its own (the caller
    passes ``n_iter = max_i k_i <= k_max``: no iteration runs past the
    longest draft).

    ``packed`` is ``(B, 3 + n_pmax)`` int32: ``[:, 0]`` last committed
    token, ``[:, 1]`` its position (-1 = inactive row), ``[:, 2]`` the
    row's draft length k, ``[:, 3:]`` block tables; row i stops writing
    after its own k. Entries of ``drafts`` past a row's k are garbage the
    host ignores.

    ``quantized=True``: the first operand is the draft row itself, leading
    axis 1: the int8 pack of the draft particle's row, dequantized
    (``spec_draft_pack``); the pages are still read through the slot's
    view."""
    def make(ctx):
        def fused(stacked_params, pages, packed):
            tok, sl = packed[:, 0], packed[:, 1]
            k_lens, bt = packed[:, 2], packed[:, 3:]
            row = slice(slot, slot + 1)
            params_row = stacked_params if quantized else tree_map(
                lambda a: a[row], stacked_params)
            pages_row = tree_map(lambda a: a[row], pages)
            drafts = []
            for j in range(n_iter):
                live = (sl >= 0) & (j < k_lens)
                logits, _ = decode_fn(params_row, pages_row, tok, bt,
                                      torch.where(live, sl, -1))
                nxt = logits[0].argmax(-1).to(torch.int32)
                tok = torch.where(live, nxt, tok)
                sl = sl + live.to(sl.dtype)
                drafts.append(tok)
            if not drafts:
                return packed.new_zeros((packed.shape[0], 0)), pages
            return torch.stack(drafts, dim=1), pages

        return fused

    return ProgramSpec(
        name="spec_draft_step",
        key=("spec_draft_step", slot, n_iter) + (("quantized",) if quantized
                                                  else ()) + tuple(key),
        make=make,
        in_kinds=("state", "state", "replicated"),
        out_kinds=("replicated", "in:1"))


def spec_draft_pack(dtype) -> ProgramSpec:
    """The int8 draft's pack: ``fused(stacked_params, pack, row, slot) ->
    (pack, row)`` writes ``precision.quantize_int8`` of particle
    ``slot``'s row (leading axis 1) into ``pack`` and its dequantization
    to ``dtype`` into ``row``, held in the row buffer's dtype, both in
    place (``precision.quantize_int8_into``). ``slot`` is a copied scalar,
    so one program serves every slot; the row is gathered one leaf at a
    time."""
    def make(ctx):
        def fused(stacked_params, pack, row, slot):
            idx = torch.as_tensor(slot).reshape(1).long()
            precision_mod.quantize_int8_into(
                pack, stacked_params, row, dtype=dtype,
                take=lambda a: a.index_select(0, idx))
            return pack, row

        return fused

    return ProgramSpec(
        name="spec_draft_pack",
        key=("spec_draft_pack", precision_mod.dtype_name(dtype)), make=make,
        in_kinds=("state", "state", "state", "replicated"),
        out_kinds=("in:1", "in:2"))


def spec_verify(verify_fn: Callable, reduce_fn: Callable, *, w_max: int,
                key: Tuple = ()) -> ProgramSpec:
    """Score a drafted window across every particle in one pass:
    ``fused(stacked_params, pages, packed, mask) -> (heads, pages)``.

    ``verify_fn(params, pages, tokens (B, W), block_tables, seq_lens,
    win_lens) -> (logits (P, B, W, V), pages)``. ``packed`` is
    ``(B, w_max + 2 + n_pmax)`` int32: ``[:, :w_max]`` window tokens (the
    last committed token, then the drafts), ``[:, w_max]`` the position of
    window token 0 (-1 = inactive), ``[:, w_max + 1]`` the live window
    length, ``[:, w_max + 2:]`` block tables. ``reduce_fn(member_logits,
    mask)`` gives the per-position heads the accept rule reads.

    Verify rewrites the draft particle's drafted KV rows along with every
    other particle's. The reference relies on that rewrite being
    bit-identical; on the card the W-row GEMMs may differ from the draft's
    1-row GEMMs in the last bits, but verify writes last, so the pool
    holds verify's values either way and stays consistent with the heads
    it returned."""
    def members(stacked_params, pages, packed):
        tokens = packed[:, :w_max]
        seq_lens = packed[:, w_max]
        win_lens = packed[:, w_max + 1]
        bt = packed[:, w_max + 2:]
        return verify_fn(stacked_params, pages, tokens, bt, seq_lens,
                         win_lens)

    def make(ctx):
        def fused(stacked_params, pages, packed, mask):
            logits, pages = members(stacked_params, pages, packed)
            return reduce_fn(logits, mask), pages

        return fused

    key = ("spec_verify", w_max) + tuple(key)
    return ProgramSpec(
        name="spec_verify", key=key,
        make=make, in_kinds=("state", "state", "replicated", "replicated"),
        out_kinds=("replicated", "in:1"),
        split=_paged_split(key, members, reduce_fn))


def _serving(prec):
    """The policy a serving spec casts under: None for one that does not
    (the fp32 default), whose spec then carries no precision token."""
    prec = precision_mod.get(prec)
    return prec if prec.casts_serve else None


def served(forward: Callable, prec) -> Callable:
    """``forward(stacked_params, *rest)`` under a serving policy: the served
    copy's int8 packs expand and every float leaf goes to the serve dtype
    at the top (``precision.dequantize``), as do the floats of the LAST
    argument (the batch), and the member outputs come back in fp32, so
    the heads reduce in fp32 whatever the members computed in. ``prec``
    None: ``forward`` itself."""
    if prec is None:
        return forward

    def fwd(stacked_params, *rest):
        stacked_params = precision_mod.dequantize(stacked_params, prec.serve)
        rest = rest[:-1] + (precision_mod.cast_floats(rest[-1],
                                                      prec.serve),)
        out = forward(stacked_params, *rest)
        if isinstance(out, tuple):          # (member outputs, state)
            return (precision_mod.cast_floats(out[0], torch.float32),
                    ) + out[1:]
        return precision_mod.cast_floats(out, torch.float32)

    return fwd


def bma_step(forward: Callable, reduce_fn: Callable, *,
             key: Tuple = (), precision=None) -> ProgramSpec:
    """One stateful serving step (dense-cache LM decode): ``fused(
    stacked_params, state, batch, mask) -> (heads, state)``.

    ``forward(stacked_params, state, batch) -> (member outputs, state)``
    updates the per-particle state (the dense KV caches) in place;
    ``reduce_fn(member_outputs, mask)`` gives the BMA heads. A Python int
    in ``batch`` (a decode position) crosses into a captured step as a
    0-d device tensor, so one program serves every position. Under a
    ``precision`` that casts for serving, the body runs ``served(forward,
    precision)`` and the spec carries the policy's key."""
    from ..models import tp
    prec = _serving(precision)
    served_fwd = served(forward, prec)

    def fwd(stacked_params, state, batch):
        return served_fwd(tp.entry(stacked_params), state, batch)

    def make(ctx):
        def fused(stacked_params, state, batch, mask):
            outs, state = fwd(stacked_params, state, batch)
            return reduce_fn(outs, mask), state

        return fused

    key = ("bma_step",) + tuple(key)
    pkey = None if prec is None else prec.key()
    return ProgramSpec(
        name="bma_step", key=key, make=make,
        in_kinds=("state", "rows", "replicated", "replicated"),
        out_kinds=("replicated", "in:1"), precision=pkey,
        split=_split(key, lambda ctx: fwd,
                     lambda ctx: lambda outs, mask: reduce_fn(outs, mask),
                     ("state", "rows", "replicated"), ("replicated", "in:1"),
                     "replicated", pkey))


def bma_predict(forward: Callable, heads_fn: Callable, *, members: bool,
                key: Tuple = (), precision=None) -> ProgramSpec:
    """The stateless BMA forward of one request batch (counterpart of the
    reference engine's ``bma_predict``): ``fused(stacked_params, batch,
    mask) -> heads``, or ``(heads, member outputs)`` with ``members``.

    ``forward(stacked_params, batch) -> member outputs (P, B, ...)``;
    ``heads_fn(outs, mask)`` gives the heads. The params are read in
    place (a static stacked tree or the store's), the batch (one bucket
    of rows, host or device) and the (P,) mask are copied into the
    program's static inputs, so one program serves every batch of its
    bucket and every churn of the mask. Under a ``precision`` that casts
    for serving, the params are the serve copy, the body runs
    ``served(forward, precision)`` (the packs dequantized and the batch
    cast at its top, the members widened to fp32) and the spec carries
    the policy's key."""
    prec = _serving(precision)
    fwd = served(forward, prec)

    from ..models import tp

    def reduce(outs, mask):
        heads = heads_fn(outs, mask)
        return (heads, outs) if members else heads

    def make(ctx):
        def fused(stacked_params, batch, mask):
            return reduce(fwd(tp.entry(stacked_params), batch), mask)

        return fused

    key = ("bma_predict", members) + tuple(key)
    pkey = None if prec is None else prec.key()
    return ProgramSpec(
        name="bma_predict", key=key,
        make=make, in_kinds=("state", "replicated", "vector"),
        precision=pkey,
        split=_split(key, lambda ctx: lambda p, b: (fwd(tp.entry(p), b),),
                     lambda ctx: reduce, ("state", "replicated"),
                     ("replicated",), "vector", pkey))


def serve_cast(precision) -> ProgramSpec:
    """The serve copy's refresh: ``fused(stacked_masters, copy) ->
    (copy,)`` writes ``precision.cast_for_serve(masters)`` into ``copy``
    (a ``precision.serve_copy_like`` tree) in place, so the copy keeps its
    addresses and the programs captured on it stay valid across store
    commits. One program per (policy, masters, copy): no ``ident``, so
    every engine over the same store and policy shares it."""
    prec = precision_mod.get(precision)

    def make(ctx):
        return lambda masters, copy: (
            precision_mod.cast_for_serve_into(copy, masters),)

    return ProgramSpec(
        name="serve_cast", key=("serve_cast",), make=make,
        in_kinds=("state", "state"), out_kinds=("in:1",),
        precision=prec.key())
