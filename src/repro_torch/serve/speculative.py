"""Speculative BMA decoding: one particle drafts, the ensemble verifies
(counterpart of ``repro.serve.speculative``, DESIGN.md §14).

The plain decode step pays its launches and its particle fan-out once per
token. Any single particle is a cheap approximation of the Bayesian model
average, so a *draft particle* (the first live slot) proposes K tokens per
sequence through the single-token paged decode over a one-particle view
(``runtime.specs.spec_draft_step``); then ONE verify pass scores the whole
(K+1)-token window across every particle
(``runtime.specs.spec_verify``, through the window kernel, which reads
each KV page once per window), and the scheduler accepts the longest
prefix on which the drafts equal the BMA argmax. Every emitted token IS a
verify BMA argmax, so greedy decode stays token-exact against the plain
scheduler; the draft's quality moves only the speed.

Rollback: the draft writes the draft particle's KV for positions
``n-1 .. n+k-2``; verify rewrites them and writes every other particle's
window KV before attending, so after accepting m tokens the pool holds,
for positions ``<= n+m-2``, what m committed steps would have left. KV past
the accepted prefix is stale but unreachable (the kernels mask by
position), so rollback is host page accounting: ``PagePool.release_tail``
returns any page the rejected tail had crossed into.

Churn (``p_clone`` / ``p_kill`` under ``step_lock``): the draft reads its
particle's rows in place through ``a[slot:slot+1]`` views, so each draft
program is captured for one slot (the reference slices a traced slot
scalar instead). Warmup therefore captures the draft at every slot of the
store's capacity and every iteration count: killing the drafting particle
re-picks the first live slot and switches programs (``slot_uploads``
counts the switches), and nothing is captured after warmup. Reading the
slot on the device instead would gather the draft particle's whole
parameter tree on every draft.

The int8 draft (``SpecConfig(quantized=True)``): the draft particle's
row is packed per output channel (``precision.quantize_int8``) into a
persistent buffer and dequantized to the serve dtype (fp32 when the
policy does not cast) into a persistent row, held in the model's dtype
(``model_dtype``, its config's) when that is wider, both rewritten by
one ``spec_draft_pack`` program when the params' version or the draft
slot changes (``stats["draft_packs"]``): the slot is a copied scalar, so
the one pack program serves every slot. The draft reads that row, the
same values the reference dequantizes inside its draft program, so each
draft program per (slot, iteration count) still reads its slot's pages
through a view, but no draft program holds a copy of the weights.

Spans (DESIGN.md §12, cat ``decode``): ``decode.draft`` and
``decode.verify`` a step, the ``decode.rollback`` instant where a
rejected tail gives pages back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import precision as precision_mod
from ..core.store import Sharded
from ..core.tree import tree_map
from ..obs import trace as _trace
from ..runtime.bucketing import bucket_size
from ..runtime.program import ProgramSpec, arg_key, device_guard, ident
from ..runtime.specs import spec_draft_pack, spec_draft_step, spec_verify
from .batcher import DecodeScheduler, _Seq, _to_host
from .engine import PagedDecodeEngine, sample_heads


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode policy (``serve_decode(speculative=...)``).

    k_max:      most tokens drafted per sequence per step (per-sequence K
                adapts below it).
    adaptive:   drive per-sequence K from an acceptance-rate EMA.
    ema_alpha:  EMA smoothing of the measured acceptance rate.
    ema_init:   optimistic prior (start at full K, shrink on evidence).
    quantized:  draft from an int8 pack of the draft particle's row
                (dequantized to the serve dtype); verify still reads the
                full-precision particles, so the tokens do not change.
    """
    k_max: int = 4
    adaptive: bool = True
    ema_alpha: float = 0.3
    ema_init: float = 1.0
    quantized: bool = False

    def __post_init__(self):
        if self.k_max < 1:
            raise ValueError("k_max must be >= 1")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")


def resolve_spec_config(speculative) -> Optional[SpecConfig]:
    """``None``/``False`` -> off; ``True`` -> defaults; int -> that
    ``k_max``; a ``SpecConfig`` passes through."""
    if speculative is None or speculative is False:
        return None
    if speculative is True:
        return SpecConfig()
    if isinstance(speculative, SpecConfig):
        return speculative
    if isinstance(speculative, int):
        return SpecConfig(k_max=speculative)
    raise TypeError(f"speculative= takes None/bool/int/SpecConfig, "
                    f"got {type(speculative).__name__}")


class SpecDecodeEngine(PagedDecodeEngine):
    """PagedDecodeEngine plus the two speculative calls, each through
    the engine's ProgramCache.

      draft_step(packed, slot)   up to K greedy tokens per row from ONE
                                 particle (or its int8 pack), the argmax
                                 fed back: one program per (slot,
                                 iteration count),
                                 ``stats["slot_uploads"]`` counting the
                                 calls whose slot differs from the last
                                 call's (the reference's slot uploads),
                                 ``stats["draft_packs"]`` the int8
                                 packs built;
      verify_step(packed)        the W = K+1 token window scored by every
                                 particle in one pass, per-position BMA
                                 heads and argmax reduced on the device.
    """

    def __init__(self, decode_fn: Callable, prefill_fn: Callable,
                 verify_fn: Callable, *, spec_cfg: SpecConfig,
                 model_dtype: Optional[torch.dtype] = None, **kw):
        place = kw.get("placement") or kw["store"].placement
        if place.mesh is not None and spec_cfg.quantized:
            raise NotImplementedError(
                "the int8 draft on a mesh is not ported: draft from the "
                "particle's own row (quantized=False)")
        super().__init__(decode_fn, prefill_fn, **kw)
        self.verify_fn = verify_fn
        self.model_dtype = model_dtype
        self.spec_cfg = spec_cfg
        self.k_max = spec_cfg.k_max
        self.w_max = spec_cfg.k_max + 1
        self._draft_slot_memo: Any = None   # (mask object, slot)
        self._last_draft_slot: Optional[int] = None
        self.stats["draft_iterations"] = 0
        self.stats["slot_uploads"] = 0
        self.stats["draft_packs"] = 0
        self._draft_specs: Dict[Any, ProgramSpec] = {}
        self._pack: Any = None      # (pack, row, row's key, params key)
        self._pack_memo: Any = None     # (params version, slot)
        self._verify = self._with_precision(spec_verify(
            verify_fn, sample_heads, w_max=self.w_max,
            key=(ident(verify_fn), self.kind)))

    def close(self):
        self._pack = self._pack_memo = None
        super().close()

    def _dequant_dtype(self) -> torch.dtype:
        prec = self.precision
        return prec.serve if prec.casts_serve else torch.float32

    def _row_dtype(self) -> torch.dtype:
        """The int8 draft row's storage: the dequantized values, held in
        the model's compute dtype when that is wider (the model widens
        every weight to its activations', so it computes the same), and
        no draft program widens them again."""
        dd = self._dequant_dtype()
        if self.model_dtype is None:
            return dd
        return torch.promote_types(dd, self.model_dtype)

    def active_mask(self):
        return self.store.active_mask()

    def pick_draft_slot(self, mask) -> int:
        """First live slot of the store's active mask, memoized on the mask
        object (the store caches it between lifecycle events, so the host
        reads it once per churn event, not per step)."""
        memo = self._draft_slot_memo
        if memo is not None and memo[0] is mask:
            return memo[1]
        live = torch.nonzero(mask > 0)
        if live.numel() == 0:
            raise RuntimeError("no live particles to draft from")
        slot = int(live[0, 0])
        self._draft_slot_memo = (mask, slot)
        return slot

    def _draft_spec(self, slot: int, n_iter: int,
                    position: int = 0) -> ProgramSpec:
        spec = self._draft_specs.get((slot, n_iter, position))
        if spec is None:
            spec = self._with_precision(spec_draft_step(
                self.decode_fn, slot=slot, n_iter=n_iter,
                key=(ident(self.decode_fn), position),
                quantized=self.spec_cfg.quantized))
            self._draft_specs[(slot, n_iter, position)] = spec
        return spec

    def _draft_params(self, params, slot: int):
        """The draft program's first operand and its cache-key entry: the
        served stacked params, or with ``quantized`` the dequantized int8
        pack of ``slot``'s row, rebuilt in place (one ``spec_draft_pack``
        run) when the params' version or the slot changed since the last
        build. The pack is a derived value: never a store key."""
        if not self.spec_cfg.quantized:
            return params, self._params_key
        if self._pack is None or self._pack[3] != self._params_key:
            def row_like(a):
                return torch.empty((1,) + tuple(a.shape[1:]),
                                   dtype=self._row_dtype(), device=a.device)
            rows = tree_map(lambda a: a[:1], params)
            pack = precision_mod.quantize_int8_like(rows)
            row = tree_map(row_like, params)
            self._pack = (pack, row, arg_key("state", row), self._params_key)
            self._pack_memo = None
        memo = (self._params_version, slot)
        if memo != self._pack_memo:
            pack, row = self._pack[0], self._pack[1]
            spec = self._with_precision(spec_draft_pack(
                self._dequant_dtype()))
            self.cache.run(spec, params, pack, row, slot,
                           state_token=self._state_token())
            self._pack_memo = memo
            self.stats["draft_packs"] += 1
        return self._pack[1], self._pack[2]

    def draft_step(self, packed: np.ndarray, slot: int):
        """packed: (B, 3 + n_pmax) int32 host array — [last token, its
        position (-1 inactive), k, block tables]. Runs max_i k_i draft
        iterations over particle ``slot``. Returns the (B, max_i k_i)
        drafted tokens on the device (entries past a row's k are
        garbage)."""
        self.stats["calls"] += 1
        if slot != self._last_draft_slot:
            self._last_draft_slot = slot
            self.stats["slot_uploads"] += 1
        _, params = self._mask_and_params()
        params, params_key = self._draft_params(params, slot)
        n_iter = int(packed[:, 2].max()) if len(packed) else 0
        self.stats["draft_iterations"] += n_iter
        pages, pages_key = self._checkout_pages()
        try:
            if isinstance(params, Sharded):
                # on a mesh the draft runs on the data position (and its
                # model group) that holds the drafter's row
                i, local = params.locate(slot)
                args = (params.shards[i], pages.shards[i], packed)
                with device_guard(params.devices[i]):
                    prog = self._program(
                        self._draft_spec(local, n_iter, i), args,
                        (params_key[2][i], pages_key[2][i], None))
                    drafts, _ = prog(*args)
            else:
                args = (params, pages, packed)
                prog = self._program(self._draft_spec(slot, n_iter), args,
                                     (params_key, pages_key, None))
                drafts, pages = prog(*args)
        finally:
            self.store.commit(self.pages_key, pages)
        return drafts

    def verify_step(self, packed: np.ndarray):
        """packed: (B, w_max + 2 + n_pmax) int32 host array — [window
        tokens, window-start position (-1 inactive), window length, block
        tables]. Returns the per-position heads (each (B, w_max))."""
        return self._run_paged(self._verify, packed)


class _SpecState:
    """Per-sequence adaptive-K state (keyed by sid: it survives preemption
    and replay and is dropped at retirement)."""
    __slots__ = ("ema", "k")

    def __init__(self, ema: float, k: int):
        self.ema = ema
        self.k = k


class SpeculativeDecodeScheduler(DecodeScheduler):
    """DecodeScheduler whose step drafts K tokens per sequence and verifies
    them in one pass: a variable number of tokens per step, the plain
    scheduler's tokens.

    One iteration: admit (unchanged) -> ensure pages THROUGH the drafted
    window -> ONE draft call (skipped when every row's K is 0) -> ONE
    verify call -> per row, accept the longest draft prefix that matches
    the BMA argmax (cut at eos), roll the rejected tail's pages back, update
    the acceptance EMA, retire.
    """

    def __init__(self, engine: SpecDecodeEngine, pool, **kw):
        super().__init__(engine, pool, **kw)
        cfg = engine.spec_cfg
        self.spec_cfg = cfg
        self.k_max = cfg.k_max
        self.w_max = cfg.k_max + 1
        self._spec_state: Dict[int, _SpecState] = {}
        # fixed-shape staging, refilled in place, one H2D each per call:
        # draft [tok, pos, k, bt...], verify [window tokens, pos, win_len,
        # bt...]
        self._draft_packed = np.zeros((self.max_active, 3 + self.n_pmax),
                                      np.int32)
        self._verify_packed = np.zeros(
            (self.max_active, self.w_max + 2 + self.n_pmax), np.int32)
        self.spec_stats: Dict[str, Any] = {
            "spec_steps": 0, "draft_calls": 0, "verify_calls": 0,
            "drafted_tokens": 0, "accepted_tokens": 0, "rollback_pages": 0,
        }

    # -- adaptive K ----------------------------------------------------------
    def _state_for(self, seq: _Seq) -> _SpecState:
        st = self._spec_state.get(seq.sid)
        if st is None:
            st = _SpecState(self.spec_cfg.ema_init, self.k_max)
            self._spec_state[seq.sid] = st
        return st

    def _plan_k(self, seq: _Seq) -> int:
        """Tokens to draft for ``seq`` this iteration: the adaptive-K
        target clipped to what the sequence can still emit (k <=
        remaining - 1 keeps every emitted token a verify output)."""
        remaining = seq.max_new - len(seq.generated)
        k = self._state_for(seq).k if self.spec_cfg.adaptive else self.k_max
        return max(0, min(k, remaining - 1, self.k_max))

    def _observe_acceptance(self, seq: _Seq, k: int, accepted: int):
        if not self.spec_cfg.adaptive or k < 1:
            return
        st = self._state_for(seq)
        a = self.spec_cfg.ema_alpha
        st.ema = (1.0 - a) * st.ema + a * (accepted / k)
        st.k = max(1, min(self.k_max, 1 + round(st.ema * (self.k_max - 1))))

    # -- step loop -----------------------------------------------------------
    def warmup(self, prompt_buckets=()):
        """Capture the draft at every slot of the store's capacity and every
        iteration count 1..k_max, and the verify, with every row masked
        inactive (no real page is written), and one prefill per requested
        pow2 prompt bucket with zero tokens. After this, admission,
        retirement, preemption within the warmed buckets and clone/kill
        churn within capacity (a re-picked draft slot included) capture
        nothing more. The single-token decode step is the draft's, so it is
        warmed with it."""
        with self.step_lock:
            d = self._draft_packed
            for slot in range(self.engine.store.capacity):
                for n_iter in range(1, self.k_max + 1):
                    d[:] = 0
                    d[:, 1] = -1
                    d[:, 2] = n_iter      # every row inactive
                    self.engine.draft_step(d, slot).cpu()
            v = self._verify_packed
            v[:] = 0
            v[:, self.w_max] = -1
            _to_host(self.engine.verify_step(v))
            for b in prompt_buckets:
                buf = self._prefill_buf(bucket_size(int(b)))
                buf[:] = 0
                _to_host(self.engine.prefill(buf))

    def _step(self):
        self._admit()
        active = [(i, s) for i, s in enumerate(self._rows) if s is not None]
        if not active:
            if self._waiting:     # admission blocked on a dry pool
                time.sleep(1e-3)
            return
        # grow THROUGH the drafted window: the draft writes positions
        # len-1 .. len-2+k, verify one more; submit-time bounds guarantee
        # that the window fits a sequence's page cap
        plans: Dict[int, int] = {}
        for i, seq in active:
            if self._rows[i] is not seq:
                continue
            k_i = self._plan_k(seq)
            if self._ensure_page(seq, extra=k_i):
                plans[seq.sid] = k_i
        active = [(i, s) for i, s in enumerate(self._rows) if s is not None]
        if not active:
            return
        slot = self.engine.pick_draft_slot(self.engine.active_mask())

        drafts = None
        if any(plans.get(s.sid, 0) > 0 for _, s in active):
            with _trace.span("decode.draft", "decode", rows=len(active),
                             slot=slot,
                             tokens=sum(plans.get(s.sid, 0)
                                        for _, s in active)):
                d = self._draft_packed
                d[:, 0] = 0
                d[:, 1] = -1
                d[:, 2:] = 0
                for i, seq in active:
                    d[i, 0] = seq.all_tokens[-1]
                    d[i, 1] = len(seq.all_tokens) - 1
                    d[i, 2] = plans.get(seq.sid, 0)
                    self.pool.fill_block_row(seq.sid, d[i, 3:])
                self.stats["h2d_transfers"] += 1
                drafts = self.engine.draft_step(d, slot).cpu().numpy()
            self.spec_stats["draft_calls"] += 1
            self.spec_stats["drafted_tokens"] += int(
                sum(plans.get(s.sid, 0) for _, s in active))

        with _trace.span("decode.verify", "decode", rows=len(active)):
            v = self._verify_packed
            v[:] = 0
            v[:, self.w_max] = -1
            for i, seq in active:
                k_i = plans.get(seq.sid, 0)
                v[i, 0] = seq.all_tokens[-1]
                if k_i:
                    v[i, 1:1 + k_i] = drafts[i, :k_i]
                v[i, self.w_max] = len(seq.all_tokens) - 1
                v[i, self.w_max + 1] = k_i + 1
                self.pool.fill_block_row(seq.sid, v[i, self.w_max + 2:])
            self.stats["h2d_transfers"] += 1
            heads = _to_host(self.engine.verify_step(v))
        self.spec_stats["verify_calls"] += 1
        self.spec_stats["spec_steps"] += 1
        self.stats["steps"] += 1
        self.stats["active_row_steps"] += len(active)

        for i, seq in active:
            k_i = plans.get(seq.sid, 0)
            bma = heads["token"][i]             # (W,) per-position argmax
            # accept rule: position 0's argmax is always right (it
            # conditions only on committed tokens); draft j survives iff it
            # equals the BMA argmax at position j-1, and each surviving
            # draft unlocks the argmax after it
            m = 1
            while m <= k_i and int(drafts[i, m - 1]) == int(bma[m - 1]):
                m += 1
            emitted = 0
            for j in range(m):
                self._append_window_token(seq, heads, i, j)
                emitted += 1
                if seq.finish_reason() == "eos":
                    break
            self.spec_stats["accepted_tokens"] += max(0, emitted - 1)
            self._observe_acceptance(seq, k_i, m - 1)
            # rollback: keep the pages the accepted prefix needs (entries
            # for all_tokens[:-1]); the rejected tail's pages go back
            freed = self.pool.release_tail(seq.sid, len(seq.all_tokens) - 1)
            if freed:
                self.spec_stats["rollback_pages"] += freed
                _trace.instant("decode.rollback", "decode", sid=seq.sid,
                               pages=freed)
            self._maybe_retire(i, seq)

    def _append_window_token(self, seq: _Seq, heads, i: int, j: int):
        seq.generated.append(int(heads["token"][i, j]))
        seq.logprobs.append(float(heads["logprob"][i, j]))
        seq.entropy.append(float(heads["entropy"][i, j]))
        seq.mutual_info.append(float(heads["mutual_info"][i, j]))
        self.stats["generated_tokens"] += 1

    # -- bookkeeping overrides ------------------------------------------------
    def _maybe_retire(self, row: int, seq: _Seq):
        done = seq.finish_reason() is not None
        super()._maybe_retire(row, seq)
        if done:
            self._spec_state.pop(seq.sid, None)

    def _fail_all(self, e: BaseException):
        super()._fail_all(e)
        self._spec_state.clear()

    def snapshot_stats(self) -> Dict[str, Any]:
        out = super().snapshot_stats()
        ss = dict(self.spec_stats)
        drafted = max(1, ss["drafted_tokens"])
        ss["acceptance_rate"] = ss["accepted_tokens"] / drafted
        steps = max(1, ss["spec_steps"])
        ss["tokens_per_step"] = self.stats["generated_tokens"] / steps
        ss["k_max"] = self.k_max
        ss["adaptive"] = self.spec_cfg.adaptive
        ss["quantized"] = self.spec_cfg.quantized
        ks = [st.k for st in self._spec_state.values()]
        ss["mean_k"] = (sum(ks) / len(ks)) if ks else float(self.k_max)
        out["speculative"] = ss
        return out
