"""Serving front-ends (counterpart of ``repro.serve.service``).

    svc = serve(infer_or_pd)                   # after bayes_infer(...)
    pred = svc.predict(x)                      # one example -> Prediction
    fut  = svc.predict_async(x)                # PendingPrediction
    pred = fut.result()                        # Prediction
    heads = svc.predict_batch(batch)           # caller-batched fast path

    svc = serve_decode(pd, cfg, num_pages=256, page_size=16)
    gen = svc.generate(prompt_ids, max_new=32)       # Generation
    h   = svc.generate_async(ids, max_new=8)         # streaming handle
    svc = serve_decode(pd, cfg, ..., speculative=4)  # draft 4, verify 5

``serve`` wires a ``PredictiveEngine`` (the BMA forward and heads, one
captured program per batch bucket) to a ``MicroBatcher`` (request
coalescing). ``stats()`` gives the batcher's request and batch counts,
flush-trigger mix, queue depth, padding occupancy and host-to-device
copies, the engine's, and p50/p95/p99 request latency.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ..core.messages import PFuture
from ..core.store import ParticleStore
from ..core.tree import tree_map
from ..models import api as models_api
from ..obs import clock, metrics
from ..runtime.cache import ProgramCache
from .batcher import DecodeScheduler, Generation, MicroBatcher
from .engine import PagedDecodeEngine, PredictiveEngine
from .paging import PagePool, create_kv_pages
from .speculative import (SpecDecodeEngine, SpeculativeDecodeScheduler,
                          resolve_spec_config)


def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); 0.0 on empty input."""
    return metrics.percentile(xs, q)


@dataclass
class Prediction:
    """One request's posterior-predictive summary (every head computed
    inside the BMA program), each a numpy row."""
    mean: Any                       # BMA mean (probs / regression mean)
    variance: Any                   # particle disagreement
    entropy: Any                    # total predictive uncertainty
    mutual_info: Any                # epistemic part (BALD)
    expected_entropy: Any = None    # aleatoric part
    extras: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_heads(heads: Dict[str, Any]) -> "Prediction":
        known = ("mean", "variance", "entropy", "mutual_info",
                 "expected_entropy")
        return Prediction(**{k: heads[k] for k in known if k in heads},
                          extras={k: v for k, v in heads.items()
                                  if k not in known})


class PendingPrediction:
    """Async handle: wraps the batcher's PFuture; ``result()`` blocks."""

    __slots__ = ("_future",)

    def __init__(self, future: PFuture):
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Prediction:
        return Prediction.from_heads(self._future.wait(timeout))


class PredictiveService:
    """``serve(...)`` handle: single-example requests coalesced by a
    ``MicroBatcher`` into the engine's bucketed BMA programs, plus the
    caller-batched ``predict_batch``. The batcher stages rows in pinned
    host memory when the engine runs on the card."""

    def __init__(self, engine: PredictiveEngine, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 512,
                 warm_on_first_flush: bool = False):
        self.engine = engine
        self._warm_on_first_flush = warm_on_first_flush
        self.batcher = MicroBatcher(
            self._predict_flush, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            pin_memory=engine.device.type == "cuda")
        self._t_start = clock.now()

    def _predict_flush(self, batch):
        """One flush on the batcher's worker; the first one, when asked,
        first captures every bucket up to ``max_batch``'s on its first
        row's structure."""
        if self._warm_on_first_flush:
            self._warm_on_first_flush = False
            self.engine.warmup(tree_map(lambda x: x[0], batch),
                               self.batcher.max_batch)
        return self.engine.predict(batch)

    # -- request paths -------------------------------------------------------
    def predict_async(self, x) -> PendingPrediction:
        """Enqueue ONE example (no leading batch axis) for the next
        micro-batch; returns at once."""
        return PendingPrediction(self.batcher.submit(x))

    def predict(self, x, timeout: Optional[float] = None) -> Prediction:
        """Synchronous single-example predict (enqueue and wait)."""
        return self.predict_async(x).result(timeout)

    def predict_batch(self, batch, members: bool = False):
        """A caller-assembled batch straight through the engine (no
        coalescing wait); returns the heads dict (leading axis B), and
        with ``members=True`` also the live members' outputs."""
        return self.engine.predict(batch, members=members)

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        lat = self.batcher.latency
        bstats = self.batcher.snapshot_stats()
        elapsed = max(clock.now() - self._t_start, 1e-9)
        return {
            **bstats,
            "engine": self.engine.snapshot_stats(),
            "latency_p50_ms": lat.percentile(50) * 1e3,
            "latency_p95_ms": lat.percentile(95) * 1e3,
            "latency_p99_ms": lat.percentile(99) * 1e3,
            "requests_per_s": bstats["requests"] / elapsed,
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Flush what is pending, stop the batcher's executor, then let
        go of the engine's trees and programs."""
        self.batcher.close()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _resolve_pd(obj):
    """Accept an Infer, a PushDistribution, or anything with .push_dist."""
    pd = getattr(obj, "push_dist", obj)
    if not hasattr(pd, "store") or not hasattr(pd, "module"):
        raise TypeError(f"cannot serve {type(obj).__name__}: "
                        "expected an Infer or PushDistribution")
    return pd


def serve(obj, *, kind: str = "classify", max_batch: int = 32,
          max_wait_ms: float = 2.0, max_queue: int = 512,
          params: Any = None, forward=None, placement: Any = None,
          precision: Any = None, warmup: Any = True,
          cache: Optional[ProgramCache] = None) -> PredictiveService:
    """Turn a trained PushDistribution (or its Infer) into a batched
    posterior-predictive service: BMA over the store's live ``"params"``,
    or over a static stacked ``params=`` tree (the MultiSWAG serve-time
    samples). ``forward`` defaults to the module's.

    ``warmup=<one example>`` (a request as ``predict`` takes it) captures
    the BMA program at every batch bucket up to ``max_batch``'s before
    ``serve`` returns, on the caller's thread, so nothing is captured
    under traffic; the batcher's worker replays the graphs.
    ``warmup=True`` (the default: a module gives no example of its own)
    does the same on the first flush's first row, on the worker, before
    that flush runs; ``warmup=False`` captures each bucket on its first
    flush. Every call dispatches through ``cache`` (default: the
    engine's own, emptied by ``close``); ``ProgramCache(capturer=
    runtime.eager)`` serves the card eagerly, for comparison.

    Churn within the store's capacity (``p_kill``, ``p_clone``) changes
    only the mask that each call copies in: it captures nothing.

    ``placement=`` (default: the store's) is the mesh the BMA forward runs
    on: per position on the store's shards, the member outputs gathered
    to the first position and reduced there (``serve.engine``). Another
    plan than the store's moves the store onto it first
    (``ParticleStore.reshard``: one restack, a new generation); a static
    ``params=`` tree is split over its positions.

    ``precision=`` (a preset name or a ``Precision``) sets the serving
    policy; None takes the store's own for the store's params, and the
    PD's for a static ``params=`` tree (which leaves the store), so a PD
    built with ``precision="mixed"`` serves its bf16 copy with no flag
    here (``serve.engine``).
    """
    pd = _resolve_pd(obj)
    if placement is None:
        placement = pd.store.placement
    fwd = forward if forward is not None else pd.module.forward
    if params is not None:
        if precision is None:
            precision = getattr(pd, "precision", None)
        engine = PredictiveEngine(fwd, params=params, kind=kind, cache=cache,
                                  precision=precision, placement=placement)
    else:
        engine = PredictiveEngine(fwd, store=pd.store, kind=kind,
                                  cache=cache, precision=precision,
                                  placement=placement)
    svc = PredictiveService(engine, max_batch=max_batch,
                            max_wait_ms=max_wait_ms, max_queue=max_queue,
                            warm_on_first_flush=warmup is True)
    if warmup is not True and warmup is not False and warmup is not None:
        pd.drain()          # no NEL work may launch during a capture
        try:
            engine.warmup(warmup, max_batch)
        except BaseException:
            svc.close()
            raise
    return svc


class PendingGeneration:
    """Async handle: resolves to a ``Generation`` when the sequence
    retires (eos or max_new)."""

    __slots__ = ("_future",)

    def __init__(self, future: PFuture):
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Generation:
        return self._future.wait(timeout)


class DecodeService:
    """``serve_decode(pd, ...)`` handle: streaming generate over the
    continuous-batching DecodeScheduler. Sequences join the running decode
    grid at the next step."""

    def __init__(self, scheduler: DecodeScheduler):
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.pool = scheduler.pool
        self._t_start = clock.now()

    def generate_async(self, prompt, *, max_new: int,
                       eos_id: Optional[int] = None) -> PendingGeneration:
        """Enqueue one prompt (token id list/array); returns immediately."""
        return PendingGeneration(
            self.scheduler.submit(prompt, max_new=max_new, eos_id=eos_id))

    def generate(self, prompt, *, max_new: int, eos_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> Generation:
        """Synchronous single-sequence generate (enqueue + wait)."""
        return self.generate_async(prompt, max_new=max_new,
                                   eos_id=eos_id).result(timeout)

    def stats(self) -> Dict[str, Any]:
        lat = self.scheduler.latencies_s()
        sstats = self.scheduler.snapshot_stats()
        elapsed = max(clock.now() - self._t_start, 1e-9)
        estats = self.engine.snapshot_stats()
        cache = estats["program_cache"]
        return {
            **sstats,
            "engine": estats,
            "hits": cache["hits"], "misses": cache["misses"],
            "cold_compiles": cache["cold_compiles"],
            "latency_p50_ms": percentile(lat, 50) * 1e3,
            "latency_p95_ms": percentile(lat, 95) * 1e3,
            "latency_p99_ms": percentile(lat, 99) * 1e3,
            "tokens_per_s": sstats["generated_tokens"] / elapsed,
        }

    def close(self):
        self.scheduler.close()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_decode(pd, cfg=None, *, num_pages: int, page_size: int,
                 max_active: int = 8, max_seq_pages: Optional[int] = None,
                 eos_id: Optional[int] = None, max_queue: int = 256,
                 cache_dtype=None,
                 pages_key: str = "kv_pages", warmup: bool = True,
                 warmup_buckets=(), precision: Any = None,
                 speculative: Any = None,
                 cache: Optional[ProgramCache] = None,
                 placement: Any = None) -> DecodeService:
    """Turn a PushDistribution holding an LM ensemble, or a ParticleStore
    (one that ``checkpoint.restore_store`` handed back; pass ``cfg``), into
    a continuous-batching posterior-predictive decode service.

    Installs the paged KV pool as a store key on the PD's device (with its
    scratch page past the ``num_pages`` the PagePool hands out:
    ``models.api.paged_cache_init``), builds the host PagePool, and wires the
    PagedDecodeEngine behind a DecodeScheduler. ``max_seq_pages`` bounds
    one sequence's block table (defaults to the config's max_seq_len,
    clamped to the pool).
    ``cache_dtype`` (e.g. ``torch.bfloat16``) sets the page storage dtype;
    None takes the PD precision's ``kv_dtype``, then the model's default.
    Decode attention runs the CUDA kernel on the card and its plain version
    on the CPU (``kernels.ops``). ``warmup=True`` runs one masked
    decode step (plus one prefill per pow2 bucket in ``warmup_buckets``)
    before the first request. Prefill attention runs the prefill kernel on
    the card.

    Every step dispatches through ``cache`` (default: the engine's own,
    emptied by ``close``): captured once as a CUDA graph on the card
    and replayed, run eagerly on the CPU. Warmup captures the decode step
    (or every draft iteration count and the verify) and each warmed
    prefill bucket; ``stats()`` shows the cache's ``hits``, ``misses`` and
    ``cold_compiles`` (captures). ``cache=ProgramCache(capturer=
    runtime.eager)`` serves the card eagerly, for comparison.

    Clone/kill churn within the store's capacity (``pd.p_clone`` /
    ``pd.p_kill`` under ``svc.scheduler.step_lock``) captures nothing
    after warmup and leaves ``generation()`` alone: the params and the
    page pool keep their addresses, and the mask is copied into each step.

    ``placement=`` (default: the store's; another plan moves the store
    onto it first, ``ParticleStore.reshard``) serves a store split over a
    mesh: the decode step and the prefill run
    per position on its shards, each position's page pool on its device,
    and the heads come from the member logits gathered onto the first
    position. Under a model axis each data position's steps run its
    model group tensor-parallel (``models.tp``), the pool's kv heads split
    over the group. Speculative serving on a mesh drafts on the data
    position that holds the drafter's row and verifies per position.

    ``speculative=`` turns on speculative BMA decoding (DESIGN.md §14):
    ``True`` for the defaults, an int for that many drafted tokens per
    step, or a ``serve.SpecConfig``. Greedy output stays token-exact; only
    the number of tokens per step changes.

    ``precision=`` sets the serving policy (None: the store's own). A
    policy that casts serves a copy of the params in the serve dtype,
    rewritten in place once per store commit (``serve.engine``); int8
    packing applies to the BMA forward and the int8 draft only, so
    decode serves the plain cast. The model computes in ``cfg.dtype``
    either way.
    """
    spec_cfg = resolve_spec_config(speculative)
    store = pd if isinstance(pd, ParticleStore) else pd.store
    if placement is None:
        placement = store.placement
    store.reshard(placement)        # before the page pool is laid out
    if cfg is None and store is not pd:
        cfg = getattr(pd.module, "cfg", None)
    if cfg is None:
        raise ValueError("pass cfg= (the module carries none)")
    if cache_dtype is None:
        cache_dtype = store.precision.kv
    if max_seq_pages is None:
        max_seq_pages = -(-cfg.max_seq_len // page_size)
    n_pmax = min(max_seq_pages, num_pages)

    def decode_fn(params, pages, tokens, block_tables, seq_lens):
        return models_api.decode_step_paged(params, tokens, pages,
                                            block_tables, seq_lens, cfg)

    def prefill_fn(params, pages, tokens, block_table_row, n_tokens):
        return models_api.prefill_paged(params, tokens, pages,
                                        block_table_row, n_tokens, cfg)

    create_kv_pages(store, functools.partial(
        models_api.paged_cache_init, cfg, num_pages=num_pages,
        page_size=page_size, dtype=cache_dtype), key=pages_key)
    pool = PagePool(num_pages, page_size, max_seq_pages=n_pmax)
    if spec_cfg is not None:
        def verify_fn(params, pages, tokens, block_tables, seq_lens,
                      win_lens):
            return models_api.decode_window_paged(
                params, tokens, pages, block_tables, seq_lens, win_lens, cfg)

        engine = SpecDecodeEngine(decode_fn, prefill_fn, verify_fn,
                                  spec_cfg=spec_cfg, store=store,
                                  model_dtype=getattr(torch, cfg.dtype),
                                  n_pmax=n_pmax, pages_key=pages_key,
                                  cache=cache, precision=precision,
                                  placement=placement)
        scheduler = SpeculativeDecodeScheduler(
            engine, pool, max_active=max_active, eos_id=eos_id,
            max_queue=max_queue)
    else:
        engine = PagedDecodeEngine(decode_fn, prefill_fn, store=store,
                                   n_pmax=n_pmax, pages_key=pages_key,
                                   cache=cache, precision=precision,
                                   placement=placement)
        scheduler = DecodeScheduler(engine, pool, max_active=max_active,
                                    eos_id=eos_id, max_queue=max_queue)
    if warmup:
        scheduler.warmup(warmup_buckets)
    return DecodeService(scheduler)
