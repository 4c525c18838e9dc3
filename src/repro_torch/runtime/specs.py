"""Step builders over an explicit leading particle axis (counterpart of
``repro.runtime.specs``).

The reference wraps a per-particle function in a vmapped, donated
ProgramSpec that its ProgramCache compiles; here the model functions
already take the stacked particle axis and run eagerly, so a builder
returns a plain function over the stacked state.

Training: ``ensemble_step`` and ``ensemble_predict`` (bodies in
``core.functional``); the reference's masked ``map_step`` has no
counterpart, because SWAG collection (``bdl.swag.swag_collect``) takes
the mask itself and keeps dead rows bit for bit. Serving: ``paged_decode_step`` and
``paged_prefill`` return ``fused(stacked_params, pages, packed, mask) ->
(heads, pages)``, which unpacks the step input, runs the model over all
particles at once and reduces with ``reduce_fn(member_logits (P, B, V),
mask)``. Pages are updated in place. ``packed`` is the device copy of the
scheduler's one int32 staging buffer (one host-to-device transfer per
step).
"""
from __future__ import annotations

from typing import Callable

from ..core import functional
from ..core import precision as precision_mod


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
