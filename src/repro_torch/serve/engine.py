"""Serving engines over the ParticleStore (counterpart of
``repro.serve.engine``: ``PredictiveEngine`` with ``predict`` and, when
``stateful``, ``init_state`` / ``step``; ``PagedDecodeEngine``).

Each serving step runs every particle in one batched pass per layer and
reduces the BMA heads (and, for decode, greedy sampling) on the device.
``predict`` (one program per power-of-two batch bucket, and per
``members``), the stateful ``step``, the paged decode step and the
prefill dispatch through a ``ProgramCache`` (``runtime.cache``), as the
reference's do: captured once as a CUDA graph on the card and replayed,
run eagerly on the CPU. ``cache=`` takes a cache to share (default: one
of the engine's own, which ``close`` empties, so that the captured
graphs and their memory go with the engine);
``ProgramCache(capturer=runtime.eager)`` runs the card eagerly. Every
step returns fresh tensors.

The precision ladder (``core.precision``): an engine serves under
``precision=`` when given, else its store's policy, else fp32. A policy
that casts for serving serves a copy of the params: a static tree is
cast (and int8-packed) once, at construction; a store-backed engine
keeps one serve copy, allocated once per store generation and rewritten
in place by the ``serve_cast`` program (``runtime.specs.serve_cast``)
whenever the store's version of the params changes, so the copy keeps
its addresses and no program captured on it is captured again after a
commit, a clone or a kill. The predict and step programs dequantize the
packs and cast the batch at their top and widen the member outputs to
fp32 (``runtime.specs.served``). Under fp32 the engine serves the
masters themselves, through the programs of the pre-policy code.

On a mesh (``placement``: the store's, which an engine built with
another moves onto it, or a static tree's own) the
predict and paged decode steps run per position on the store's shards
(``runtime.program.ShardedProgram``) with no unstack or restack; the
member outputs are gathered onto the first position in slot order and
reduced there by the same heads, so the result does not depend on the
number of positions. Each position's page pool stays on its device. A
static tree whose member count the particle axis divides is split over
the positions once, at construction. The dense-cache (``stateful``)
engine on a mesh builds its caches per data position (``init_state``)
and steps them there. Under a model axis each data position's step runs
its model group tensor-parallel (``models.tp``), the kv heads of the
pool and of the dense caches split over the group.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import precision as precision_mod
from ..core.store import ParticleStore, Placement, Sharded
from ..core.tree import tree_leaves, tree_map
from ..runtime.bucketing import bucket_size, pad_rows
from ..runtime.cache import ProgramCache
from ..runtime.program import ProgramSpec, arg_key, device_guard, ident
from ..runtime.specs import (bma_predict, bma_step, paged_decode_step,
                             paged_prefill, serve_cast)
from . import uncertainty


def sample_heads(member_logits, mask):
    """BMA heads + greedy token from member logits (P, B, V), or
    (P, B, W, V) per window position (the paged engines' reduce)."""
    heads = uncertainty.predictive_heads(member_logits, "classify", mask)
    mean = heads["mean"]                        # (B, [W,] V) BMA probs
    token = mean.argmax(-1)
    logprob = torch.log(mean.gather(-1, token[..., None])[..., 0] + 1e-12)
    return {"token": token.to(torch.int32), "logprob": logprob,
            "entropy": heads["entropy"], "mutual_info": heads["mutual_info"]}


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
    "regress". ``precision`` (None: the store's policy, or fp32 for a
    static tree) decides the serve copy (module doc)."""

    def __init__(self, forward: Optional[Callable] = None, *,
                 store: Optional[ParticleStore] = None, key: str = "params",
                 params: Any = None, kind: str = "classify",
                 stateful: bool = False,
                 cache: Optional[ProgramCache] = None, precision: Any = None,
                 placement: Optional[Placement] = None):
        if (store is None) == (params is None):
            raise ValueError("pass exactly one of store= or params=")
        if kind not in uncertainty.KINDS:
            raise ValueError(f"kind must be one of {uncertainty.KINDS}")
        if placement is None:
            placement = store.placement if store is not None \
                else Placement()
        if store is not None:
            # the engine serves the store's shards where they live
            store.reshard(placement)
        self._placement = placement
        self.forward = forward
        self.store = store
        self.key = key
        self.kind = kind
        self.stateful = stateful
        if precision is None and store is not None:
            precision = store.precision
        self.precision = precision_mod.get(precision)
        if params is not None and self.precision.casts_serve:
            # a static tree has no commits: cast it once, eagerly
            with torch.no_grad():
                params = Sharded.apply(lambda t: precision_mod.cast_for_serve(
                    t, self.precision), params)
        if isinstance(params, Sharded):     # already on the positions
            self._static_mask = torch.ones(len(params),
                                           device=params.devices[0])
            layout = None
        else:
            self._static_mask = None if params is None else torch.ones(
                tree_leaves(params)[0].shape[0],
                device=tree_leaves(params)[0].device)
            layout = None if params is None \
                else placement.shardings(params)
        if layout is not None:
            # the members split over the mesh's positions, as the store's
            # particles are
            params = placement.split(params)
            self._static_mask = self._static_mask.to(layout[0][1])
        self._static_params = params
        self._params_version: Any = None
        self._params_cache: Any = None      # the served tree
        self._masters: Any = None           # the store's tree it serves
        self._serve: Any = None             # (masters' key, serve copy)
        # explicit None test: an empty ProgramCache is falsy (__len__)
        self._own_cache = cache is None
        self.cache = ProgramCache() if cache is None else cache
        # the params' cache-key entry (shapes and addresses), refreshed
        # only when the store's version of them changes: a step never
        # walks the params tree
        self._params_key = (None if params is None
                            else arg_key("state", params))
        self._step_spec: Optional[ProgramSpec] = None
        self._predict_specs: Dict[bool, ProgramSpec] = {}
        self._live_idx: Any = None          # (mask object, live rows)
        # one predict at a time: a program's static inputs and outputs
        # are shared by every call (the batcher's worker and a caller's
        # predict_batch may both call)
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"calls": 0, "compiles": 0, "bucket_hits": 0,
                      "param_refreshes": 0}

    @property
    def placement(self) -> Placement:
        """The store's plan (a later ``reshard`` included), or the static
        tree's."""
        return self.store.placement if self.store is not None \
            else self._placement

    @property
    def device(self) -> torch.device:
        """Where the served params live (and the programs run)."""
        if self.store is not None:
            return torch.device(self.store.device)
        return self._static_mask.device

    @property
    def num_particles(self) -> int:
        """Leading member axis of the served tree: the store's capacity
        (``store.live_count()`` for the live members), or the static
        tree's member count."""
        params = self._mask_and_params()[1]
        if isinstance(params, Sharded):
            return len(params)
        return tree_leaves(params)[0].shape[0]

    def stacked_params(self):
        """The served stacked params (the store's tree, or its serve copy
        under a casting policy; a ``Sharded`` one under a mesh), refreshed
        when the store's version of them moved."""
        return self._mask_and_params()[1]

    def active_mask(self):
        """The (P,) live-slot mask each call copies in: the store's, or
        all ones for a static tree."""
        return self._mask_and_params()[0]

    def _mask_and_params(self):
        """Consistent (mask, served params) pair: one atomic store
        snapshot, so a mask bit never goes live before its slot's data.
        The served params are the store's tree, or under a casting policy
        its serve copy, refreshed here when the store's version moved."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.store is None:
            return self._static_mask, self._static_params
        v, mask, stacked = self.store.snapshot(self.key)
        if v != self._params_version or stacked is not self._masters:
            self._masters, self._params_version = stacked, v
            if self.precision.casts_serve:
                self._params_cache = self._refresh_serve_copy(stacked)
            else:
                self._params_cache = stacked
                self._params_key = arg_key("state", stacked)
            self.stats["param_refreshes"] += 1
        return mask, self._params_cache

    def _refresh_serve_copy(self, masters):
        """Rewrite the serve copy from ``masters`` in place through the
        cached ``serve_cast`` program; the copy is allocated anew only when
        the masters' shapes or addresses change (capacity growth, a
        replaced tree), and its cache-key entry with it."""
        masters_key = arg_key("state", masters)
        if self._serve is None or self._serve[0] != masters_key:
            copy = Sharded.apply(lambda t: precision_mod.serve_copy_like(
                t, self.precision), masters)
            self._serve = (masters_key, copy)
            self._params_key = arg_key("state", copy)
        copy = self._serve[1]
        self.cache.run(serve_cast(self.precision), masters, copy,
                       state_token=self._state_token())
        return copy

    def _state_token(self):
        """Store generation for the cache key (particle-set changes miss;
        content commits within it keep their programs)."""
        return self.store.generation() if self.store is not None else None

    def _program(self, spec: ProgramSpec, args, arg_keys):
        prog, hit = self.cache.lookup(spec, args, self._state_token(),
                                      arg_keys)
        self.stats["bucket_hits" if hit else "compiles"] += 1
        return prog

    def _predict_spec(self, members: bool) -> ProgramSpec:
        spec = self._predict_specs.get(members)
        if spec is None:
            kind = self.kind
            spec = self._predict_specs[members] = bma_predict(
                self.forward,
                lambda outs, m: uncertainty.predictive_heads(outs, kind, m),
                members=members, key=(ident(self.forward), kind),
                precision=self.precision)
        return spec

    def predict(self, batch, members: bool = False):
        """BMA forward over a request batch (leading axis B, numpy or
        tensors, on the host or the device), as one cached program per
        power-of-two bucket (``runtime.specs.bma_predict``): B is padded
        up to its bucket (repeating the last row), every member runs at
        once, and the heads are sliced back to B. Host rows reach the
        device by one copy per leaf, into the program's static input
        (``runtime.program.h2d_copies``). ``members=True`` also returns the
        member outputs of the live rows only, in slot order (live count,
        B, ...), whatever the churn (a program of its own)."""
        if self.forward is None:
            raise RuntimeError("this engine has no forward")
        if self.stateful:
            raise RuntimeError("stateful engine: use step(state, batch)")
        batch = tree_map(lambda x: torch.as_tensor(x)
                         if isinstance(x, (np.ndarray, np.generic)) else x,
                         batch)
        m = tree_leaves(batch)[0].shape[0]
        padded = pad_rows(batch, bucket_size(m))
        with self._lock:
            self.stats["calls"] += 1
            mask, stacked = self._mask_and_params()
            args = (stacked, padded, mask)
            prog = self._program(self._predict_spec(members), args,
                                 (self._params_key, None, None))
            out = prog(*args)
        heads, outs = out if members else (out, None)
        heads = {k: v[:m] for k, v in heads.items()}
        if not members:
            return heads
        # live rows memoized on the mask object, which the store keeps
        # between lifecycle events: one host read per churn event
        if self._live_idx is None or self._live_idx[0] is not mask:
            self._live_idx = (mask, torch.nonzero(mask > 0)[:, 0])
        return heads, outs[self._live_idx[1], :m]

    def warmup(self, example, max_batch: int):
        """Run ``predict`` once at every bucket up to ``max_batch``'s, on
        rows that repeat ``example`` (one request: no leading batch axis),
        so that each bucket's program is captured before traffic."""
        rows = tree_map(torch.as_tensor, example)
        b = 1
        while b <= bucket_size(max_batch):
            self.predict(tree_map(
                lambda x, b=b: x[None].expand(b, *x.shape).clone(), rows))
            b *= 2

    def init_state(self, make_state: Callable):
        """Build the stacked per-particle serving state:
        ``make_state(stacked_params)`` over every slot of the store's
        capacity (e.g. a prefill that returns the KV caches), so the state
        is born capacity-padded. Under a casting policy ``make_state``
        sees the serve copy with its packs expanded to the serve dtype.
        On a mesh ``make_state`` runs per data position on its shard (a
        model group's under a model axis), and the state is a ``Sharded``
        of the results."""
        _, stacked = self._mask_and_params()
        with torch.no_grad():
            if self.precision.casts_serve:
                stacked = Sharded.apply(lambda t: precision_mod.dequantize(
                    t, self.precision.serve), stacked)
            if not isinstance(stacked, Sharded):
                return make_state(stacked)
            from ..models import tp
            parts = []
            for device, shard in zip(stacked.devices, stacked.shards):
                with device_guard(device):
                    parts.append(make_state(tp.entry(shard)))
            return Sharded(parts, stacked.devices, stacked.plan)

    def step(self, state, batch):
        """One stateful serving step (LM decode): ``forward`` over every
        particle at once, then the BMA heads over the live slots, as one
        cached program (``runtime.specs.bma_step``; the state is updated
        in place). The batch reaches ``forward`` as given on the CPU; in a
        captured step its tensors and Python ints arrive as the program's
        static copies. Returns (heads, state)."""
        if not self.stateful:
            raise RuntimeError("stateless engine: use predict(batch)")
        self.stats["calls"] += 1
        mask, stacked = self._mask_and_params()
        if self._step_spec is None:
            kind = self.kind
            self._step_spec = bma_step(
                self.forward,
                lambda outs, m: uncertainty.predictive_heads(outs, kind, m),
                key=(ident(self.forward), kind), precision=self.precision)
        args = (stacked, state, batch, mask)
        prog = self._program(self._step_spec, args,
                             (self._params_key, None, None, None))
        return prog(*args)

    def snapshot_stats(self) -> Dict[str, Any]:
        return dict(self.stats, program_cache=self.cache.snapshot_stats())

    def close(self):
        """Let go of the served trees (a static ``params=`` tree too), and
        drop the engine's programs when the cache is its own (a cache
        passed in belongs to the caller, and drops them once their trees
        are freed)."""
        with self._lock:
            self._closed = True
            self._params_cache = self._params_version = None
            self._masters = self._serve = None
            self._static_params = None
            if self._own_cache:
                self.cache.clear()


class PagedDecodeEngine(PredictiveEngine):
    """Continuous-batching LM decode core over the paged KV pool.

      decode_step(packed)   one token for every active row: params and
                            pages stacked over the particle axis, BMA +
                            greedy sampling on the device, pages updated in
                            place;
      prefill(packed)       admit one sequence: prompt prefill into its
                            pages + the first sampled token.

    The pages tree lives in the store under ``pages_key`` and crosses each
    call by checkout/commit; it is updated in place, so checkout hands back
    the same tensors and its cache-key entry is computed once per store
    generation. Packed inputs follow ``runtime.specs``: decode ships
    ``(B, 2 + n_pmax)`` int32, prefill ``(Sp + n_pmax + 1,)`` int32, each
    copied into its program's static input (one host-to-device copy per
    call). One decode program, one prefill program per pow2 bucket.

    Under a policy that casts for serving the steps read the serve copy in
    the serve dtype; int8 packing is dropped (``serve_quant=None``, as the
    reference does: it is a BMA-forward option). The model computes in its
    config's dtype whatever the weights' (``blocks.dense_apply`` widens
    each weight to the activations'), and every paged spec carries the
    policy's key.
    """

    def __init__(self, decode_fn: Callable, prefill_fn: Callable, *,
                 store: ParticleStore, n_pmax: int, key: str = "params",
                 pages_key: str = "kv_pages",
                 cache: Optional[ProgramCache] = None, precision: Any = None,
                 placement: Optional[Placement] = None):
        super().__init__(store=store, key=key, cache=cache,
                         precision=precision, placement=placement)
        if self.precision.serve_quant is not None:
            self.precision = dataclasses.replace(self.precision,
                                                 serve_quant=None)
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.pages_key = pages_key
        self.n_pmax = n_pmax
        self._pages_memo: Any = None        # (generation, tree, key)
        self._decode = self._with_precision(paged_decode_step(
            decode_fn, sample_heads, key=(ident(decode_fn), self.kind)))
        self._prefill = self._with_precision(paged_prefill(
            prefill_fn, sample_heads, n_pmax=n_pmax,
            key=(ident(prefill_fn), self.kind)))

    def _with_precision(self, spec: ProgramSpec) -> ProgramSpec:
        """``spec`` carrying the policy's key when the policy casts."""
        if not self.precision.casts_serve:
            return spec
        return dataclasses.replace(spec, precision=self.precision.key())

    def close(self):
        self._pages_memo = None
        super().close()

    def kv_page_info(self) -> Dict[str, Any]:
        """Dtype histogram and resident bytes of the page pool."""
        return {"key": self.pages_key,
                "dtypes": self.store.key_dtypes(self.pages_key),
                "per_device_bytes": self.store.per_device_bytes(
                    self.pages_key)}

    def _checkout_pages(self):
        """Check the pool out, with its cache-key entry (recomputed only
        when the generation or the tree itself changes)."""
        pages = self.store.checkout(self.pages_key)
        gen = self.store.generation()
        memo = self._pages_memo
        if memo is None or memo[0] != gen or memo[1] is not pages:
            self._pages_memo = memo = (gen, pages, arg_key("state", pages))
        return pages, memo[2]

    def _run_paged(self, spec: ProgramSpec, packed):
        self.stats["calls"] += 1
        mask, params = self._mask_and_params()
        pages, pages_key = self._checkout_pages()
        try:
            args = (params, pages, packed, mask)
            prog = self._program(spec, args,
                                 (self._params_key, pages_key, None, None))
            heads, pages = prog(*args)
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
