"""Serving engines over the ParticleStore (counterpart of
``repro.serve.engine``: ``PredictiveEngine`` with ``predict`` and, when
``stateful``, ``init_state`` / ``step``; ``PagedDecodeEngine``).

The reference compiles each serving step once through its ProgramCache;
the port runs each step eagerly over the stacked particle axis — every
particle in one batched pass per layer, the BMA heads (and, for decode,
greedy sampling) reduced on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.store import ParticleStore
from ..core.tree import tree_leaves, to_device
from ..runtime.bucketing import bucket_size, pad_rows
from ..runtime.specs import paged_decode_step, paged_prefill
from . import uncertainty


class PredictiveEngine:
    """Posterior-predictive core: one BMA forward per request batch.

    Stateless (the default): ``forward(stacked_params, batch) -> member
    outputs (P, B, ...)``, served by ``predict``. Stateful
    (``stateful=True``, LM decode over dense KV caches):
    ``forward(stacked_params, state, batch) -> (member outputs, state)``,
    served by ``step``; the per-particle state (leading axis P, the store's
    capacity) stays on the device across steps, dead rows riding along
    masked out of the heads. Serves either the store's stacked ``key``
    tree (cached between store commits by the store's version) with the
    store's active mask, or a static stacked ``params`` tree (serve-time
    SWAG samples) with an all-ones mask: exactly one of ``store=`` and
    ``params=``. ``kind`` is "classify" (member outputs are logits) or
    "regress"."""

    def __init__(self, forward: Optional[Callable] = None, *,
                 store: Optional[ParticleStore] = None, key: str = "params",
                 params: Any = None, kind: str = "classify",
                 stateful: bool = False):
        if (store is None) == (params is None):
            raise ValueError("pass exactly one of store= or params=")
        if kind not in uncertainty.KINDS:
            raise ValueError(f"kind must be one of {uncertainty.KINDS}")
        self.forward = forward
        self.store = store
        self.key = key
        self.kind = kind
        self.stateful = stateful
        self._static_params = params
        self._static_mask = None if params is None else torch.ones(
            tree_leaves(params)[0].shape[0],
            device=tree_leaves(params)[0].device)
        self._params_version: Any = None
        self._params_cache: Any = None
        self.stats = {"calls": 0, "param_refreshes": 0}

    def _mask_and_params(self):
        """Consistent (mask, stacked params) pair: one atomic store
        snapshot, so a mask bit never goes live before its slot's data."""
        if self.store is None:
            return self._static_mask, self._static_params
        v, mask, stacked = self.store.snapshot(self.key)
        if v != self._params_version:
            self._params_cache, self._params_version = stacked, v
            self.stats["param_refreshes"] += 1
        return mask, self._params_cache

    def predict(self, batch):
        """BMA forward over a request batch (leading axis B, numpy or
        tensors). Pads B up to the power-of-two bucket (repeating the last
        row), runs every member at once, and slices the heads back to B."""
        if self.forward is None:
            raise RuntimeError("this engine has no forward")
        if self.stateful:
            raise RuntimeError("stateful engine: use step(state, batch)")
        self.stats["calls"] += 1
        mask, stacked = self._mask_and_params()
        batch = to_device(batch, mask.device)
        m = tree_leaves(batch)[0].shape[0]
        padded = pad_rows(batch, bucket_size(m))
        with torch.no_grad():
            outs = self.forward(stacked, padded)
            heads = uncertainty.predictive_heads(outs, self.kind, mask)
        return {k: v[:m] for k, v in heads.items()}

    def init_state(self, make_state: Callable):
        """Build the stacked per-particle serving state:
        ``make_state(stacked_params)`` over every slot of the store's
        capacity (e.g. a prefill that returns the KV caches), so the state
        is born capacity-padded."""
        _, stacked = self._mask_and_params()
        with torch.no_grad():
            return make_state(stacked)

    def step(self, state, batch):
        """One stateful serving step (LM decode): ``forward`` over every
        particle at once, then the BMA heads over the live slots. The batch
        goes to ``forward`` as given. Returns (heads, new state)."""
        if not self.stateful:
            raise RuntimeError("stateless engine: use predict(batch)")
        self.stats["calls"] += 1
        mask, stacked = self._mask_and_params()
        with torch.no_grad():
            outs, state = self.forward(stacked, state, batch)
            heads = uncertainty.predictive_heads(outs, self.kind, mask)
        return heads, state

    def snapshot_stats(self) -> Dict[str, int]:
        return dict(self.stats)


class PagedDecodeEngine(PredictiveEngine):
    """Continuous-batching LM decode core over the paged KV pool.

      decode_step(packed)   one token for every active row: params and
                            pages stacked over the particle axis, BMA +
                            greedy sampling on the device, pages updated in
                            place;
      prefill(packed)       admit one sequence: prompt prefill into its
                            pages + the first sampled token.

    The pages tree lives in the store under ``pages_key`` and crosses each
    call by checkout/commit. Packed inputs follow ``runtime.specs``:
    decode ships ``(B, 2 + n_pmax)`` int32, prefill ``(Sp + n_pmax + 1,)``
    int32 — one host-to-device copy per call.
    """

    def __init__(self, decode_fn: Callable, prefill_fn: Callable, *,
                 store: ParticleStore, n_pmax: int, key: str = "params",
                 pages_key: str = "kv_pages"):
        super().__init__(store=store, key=key)
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.pages_key = pages_key
        self.n_pmax = n_pmax
        self._decode = paged_decode_step(decode_fn, self._reduce)
        self._prefill = paged_prefill(prefill_fn, self._reduce,
                                      n_pmax=n_pmax)

    def _reduce(self, member_logits, mask):
        """BMA heads + greedy token from member logits (P, B, V), or
        (P, B, W, V) per window position."""
        heads = uncertainty.predictive_heads(member_logits, self.kind, mask)
        mean = heads["mean"]                        # (B, [W,] V) BMA probs
        token = mean.argmax(-1)
        logprob = torch.log(mean.gather(-1, token[..., None])[..., 0] + 1e-12)
        return {"token": token.to(torch.int32), "logprob": logprob,
                "entropy": heads["entropy"],
                "mutual_info": heads["mutual_info"]}

    def kv_page_info(self) -> Dict[str, Any]:
        """Dtype histogram and resident bytes of the page pool."""
        return {"key": self.pages_key,
                "dtypes": self.store.key_dtypes(self.pages_key),
                "bytes": self.store.nbytes(self.pages_key)}

    def _run_paged(self, fused, packed):
        self.stats["calls"] += 1
        mask, params = self._mask_and_params()
        pages = self.store.checkout(self.pages_key)
        try:
            heads, pages = fused(params, pages,
                                 torch.from_numpy(packed).to(self.store.device),
                                 mask)
        finally:
            # the pool is updated in place: the tree handed back is the one
            # checked out, so the key stays present even after a failure
            self.store.commit(self.pages_key, pages)
        return heads

    def decode_step(self, packed):
        """packed: (B, 2 + n_pmax) int32 host array — [tokens, seq_lens,
        block tables]; rows with seq_len -1 are inactive (their heads are
        garbage — mask downstream). Returns the heads on the device."""
        return self._run_paged(self._decode, packed)

    def prefill(self, packed):
        """packed: (Sp + n_pmax + 1,) int32 host array — [prompt tokens
        padded to the Sp bucket, block table row, n_tokens]. Returns heads
        for the first generated token (leading axis 1)."""
        return self._run_paged(self._prefill, packed)
