"""Step builders over an explicit leading particle axis (counterpart of
``repro.runtime.specs``).

The reference wraps a per-particle function in a vmapped, donated
ProgramSpec that its ProgramCache compiles; here the model functions
already take the stacked particle axis and run eagerly, so a builder
returns a plain function over the stacked state.

Training: ``ensemble_step`` and ``ensemble_predict`` (bodies in
``core.functional``); the reference's masked ``map_step`` has no
counterpart, because SWAG collection (``bdl.swag.swag_collect``) takes
the mask itself and keeps dead rows bit for bit. Serving: ``paged_decode_step``,
``paged_prefill`` and ``spec_verify`` return ``fused(stacked_params,
pages, packed, mask) -> (heads, pages)``, which unpacks the step input,
runs the model over all particles at once and reduces with
``reduce_fn(member_logits (P, B, [W,] V), mask)``; ``spec_draft_step``
returns ``fused(stacked_params, pages, packed, slot, n_iter) -> (drafts,
pages)`` over one particle. Pages are updated in place. ``packed`` is the
device copy of the scheduler's one int32 staging buffer (one
host-to-device transfer per call).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import functional
from ..core import precision as precision_mod
from ..core.tree import tree_map


def ensemble_step(loss_fn: Callable, optimizer, precision=None) -> Callable:
    """One train step for all particles: ``step(params, opt_state, batch,
    mask=None) -> (params, opt_state, losses)``. Only the fp32 preset is
    ported: any other ``precision`` raises."""
    precision_mod.get(precision)
    return functional.ensemble_step(loss_fn, optimizer)


def ensemble_predict(forward: Callable) -> Callable:
    """hat f(x) = (1/n) sum_i nn_{theta_i}(x): ``f(stacked_params, batch,
    mask=None)``, mask-weighted over live slots."""
    return functional.ensemble_predict(forward)


def paged_decode_step(decode_fn: Callable, reduce_fn: Callable) -> Callable:
    """``decode_fn(params, pages, tokens, block_tables, seq_lens) ->
    (logits (P, B, V), pages)``; ``packed`` is ``(B, 2 + n_pmax)`` int32:
    ``[:, 0]`` tokens, ``[:, 1]`` seq_lens, ``[:, 2:]`` block tables."""
    def fused(stacked_params, pages, packed, mask):
        tokens, seq_lens, bt = packed[:, 0], packed[:, 1], packed[:, 2:]
        logits, pages = decode_fn(stacked_params, pages, tokens, bt, seq_lens)
        return reduce_fn(logits, mask), pages

    return fused


def paged_prefill(prefill_fn: Callable, reduce_fn: Callable, *,
                  n_pmax: int) -> Callable:
    """``prefill_fn(params, pages, tokens (1, Sp), block_table_row,
    n_tokens) -> (last-token logits (P, 1, V), pages)``; ``packed`` is
    ``(Sp + n_pmax + 1,)`` int32: ``[tokens..., block_table...,
    n_tokens]``."""
    def fused(stacked_params, pages, packed, mask):
        sp = packed.shape[0] - n_pmax - 1
        tokens = packed[None, :sp]
        bt_row = packed[sp:sp + n_pmax]
        logits, pages = prefill_fn(stacked_params, pages, tokens, bt_row,
                                   packed[-1])
        return reduce_fn(logits, mask), pages

    return fused


def spec_draft_step(decode_fn: Callable) -> Callable:
    """Draft tokens from ONE particle: the single-token decode run
    ``n_iter`` times over a one-particle view (``a[slot:slot+1]``) of the
    params and the pages, the argmax of each iteration fed back as the
    next token. The views share storage with the stacked tensors, so the
    draft's KV writes land in the pool itself.

    ``packed`` is ``(B, 3 + n_pmax)`` int32: ``[:, 0]`` last committed
    token, ``[:, 1]`` its position (-1 = inactive row), ``[:, 2]`` the
    row's draft length k, ``[:, 3:]`` block tables. The caller passes
    ``n_iter = max_i k_i`` (known on the host), so no iteration runs past
    the longest draft; row i stops writing after its own k. Returns
    ``(drafts (B, n_iter) int32, pages)``; entries past a row's k are
    garbage the host ignores."""
    def fused(stacked_params, pages, packed, slot: int, n_iter: int):
        tok, sl = packed[:, 0], packed[:, 1]
        k_lens, bt = packed[:, 2], packed[:, 3:]
        row = slice(slot, slot + 1)
        params_row = tree_map(lambda a: a[row], stacked_params)
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


def spec_verify(verify_fn: Callable, reduce_fn: Callable, *,
                w_max: int) -> Callable:
    """Score a drafted window across every particle in one pass.

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
    def fused(stacked_params, pages, packed, mask):
        tokens = packed[:, :w_max]
        seq_lens = packed[:, w_max]
        win_lens = packed[:, w_max + 1]
        bt = packed[:, w_max + 2:]
        logits, pages = verify_fn(stacked_params, pages, tokens, bt,
                                  seq_lens, win_lens)
        return reduce_fn(logits, mask), pages

    return fused
