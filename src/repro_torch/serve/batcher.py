"""Request scheduling: micro-batching (stateless) and continuous
batching (LM decode) (counterpart of ``repro.serve.batcher``:
``MicroBatcher``, ``_Request``, ``_Staging``, ``DecodeScheduler``,
``Generation``, ``_Seq``).

``MicroBatcher`` coalesces single-example requests into padded batches,
one BMA forward per batch instead of one per request, flushed by
whichever trigger fires first:

  size      the pending set reached ``max_batch`` — flush at once;
  deadline  the oldest pending request has waited ``max_wait_ms`` —
            flush whatever has accumulated (bounded tail latency);
  close     the batcher is shutting down — flush the remainder.

The flush loop runs as work items on its own ``core.executor.Executor``
(one device worker, no pool, the pump's own mailbox), scheduled only
while requests are pending. The queue is bounded: ``submit`` blocks once
``max_queue`` requests are pending. Each request is ONE example (no
leading batch axis); a flush copies the rows into a preallocated staging
buffer per batch signature (pinned host memory when the engine runs on
the card), so that each leaf crosses to the device by one copy straight
into the captured program's static input, and reads the result tree back
with one device-to-host copy per leaf and one sync.

Where flush batching admits and retires work per *flush*, the decode loop
admits and retires sequences per *decode step* (DESIGN.md §10). A fixed
grid of ``max_active`` rows runs one decode step over all particles per
iteration; finished rows free their KV pages and are refilled from the
waiting queue in the SAME loop iteration. Admission backpressure is keyed
on free pages in the PagePool; when a running row cannot get its next
page, the youngest row is preempted (pages reclaimed, sequence requeued —
greedy sampling makes the re-run deterministic). The loop runs as a work
item on its own executor, as the micro-batcher's does, so an idle
scheduler is one parked worker. ``decode_stats_for(store)`` is the
``pd.stats()["decode"]`` section of the scheduler serving that store.
Spans (DESIGN.md §12, cat ``decode``): ``decode.step`` and
``decode.prefill``, the instants ``decode.admit``, ``decode.grow``,
``decode.preempt`` and ``decode.retire``.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.executor import Executor
from ..core.messages import PFuture
from ..core.tree import tree_flatten, tree_map
from ..obs import clock, metrics
from ..obs import trace as _trace
from ..runtime.bucketing import bucket_size
from ..runtime.program import abstract_key, h2d_copies

_LAT_RING = 4096


def _to_host(heads) -> Dict[str, np.ndarray]:
    """The step's heads as host numpy arrays (the one device-to-host
    copy of a step)."""
    return {k: v.cpu().numpy() for k, v in heads.items()}


def _readback(tree, staged=()):
    """The result tree on the host as numpy: one device-to-host copy per
    device leaf, all queued before the one sync. A host leaf that shares
    memory with a ``staged`` buffer (a consumer that hands back its
    input) is copied, since the next flush refills that buffer."""
    leaves, unflatten = tree_flatten(tree)
    ptrs = {b.untyped_storage().data_ptr() for b in staged}

    def host(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cpu":
            return x.to("cpu", non_blocking=True)
        return x.clone() if x.untyped_storage().data_ptr() in ptrs else x

    out = [host(x) for x in leaves]
    dev = [x.device for x in leaves if isinstance(x, torch.Tensor)
           and x.device.type == "cuda"]
    if dev:
        torch.cuda.current_stream(dev[0]).synchronize()
    return unflatten([x.numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x) for x in out])


class _Request:
    __slots__ = ("x", "future", "t_enqueue")

    def __init__(self, x, future: PFuture):
        self.x = x
        self.future = future
        self.t_enqueue = clock.now()


class _Staging:
    """Preallocated host staging buffers, one set per (bucket, tree
    structure, leaf shapes and dtypes).

    Request rows are copied into the buffers in place and pad rows repeat
    the last real row (the semantics of ``runtime.bucketing.pad_rows``).
    With ``pin_memory`` the buffers are page-locked, so that the
    program's copy of each leaf into its static input is one
    asynchronous host-to-device copy straight from the buffer.

    Reuse across flushes is safe because stagings run one at a time
    (``MicroBatcher.run_batch`` holds a lock), and each reads its result
    back and synchronizes the stream (``_readback``) before the next one
    refills a buffer: by then the stream has run the copies out of the
    buffer, which an asynchronous copy from pinned memory would otherwise
    still be reading. ``batch`` returns the staged tree and its buffers."""

    def __init__(self, pin_memory: bool = False):
        self.pin_memory = pin_memory
        self._bufs: Dict[Any, Any] = {}
        self.builds = 0
        self.reuses = 0

    def batch(self, rows: List[Any], bucket: int):
        leaves, unflatten = tree_flatten(rows[0])
        sig = (bucket, abstract_key(rows[0]))
        bufs = self._bufs.get(sig)
        if bufs is None:
            bufs = self._bufs[sig] = [
                torch.empty((bucket,) + tuple(t.shape), dtype=t.dtype,
                            pin_memory=self.pin_memory)
                for t in map(torch.as_tensor, leaves)]
            self.builds += 1
        else:
            self.reuses += 1
        for i, row in enumerate(rows):
            for buf, leaf in zip(bufs, tree_flatten(row)[0]):
                buf[i].copy_(torch.as_tensor(leaf))
        m = len(rows)
        if m < bucket:
            for buf in bufs:
                buf[m:] = buf[m - 1]        # pad = repeat the last real row
        return unflatten(bufs), bufs


class MicroBatcher:
    """Coalesces single-example requests into padded batches for
    ``predict_fn`` (module doc). ``stats["h2d_transfers"]`` adds up the
    host-to-device copies that each flush's ``predict_fn`` call issued
    through its programs (``runtime.program.h2d_copies``, read on the
    flushing thread): one per leaf when the staged buffers go straight
    into the program, none for a consumer that stays on the host."""

    def __init__(self, predict_fn: Callable, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 512,
                 executor: Optional[Executor] = None,
                 pin_memory: bool = False):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue
        self._owns_executor = executor is None
        # one "device" worker is the flush loop; no pool threads needed
        self._exec = executor or Executor(num_devices=1, pool_size=0,
                                          max_pending=2 * max_queue)
        self._pump_pid = id(self)   # any stable key works as a mailbox id
        self._exec.add_particle(self._pump_pid, 0)
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._pump_scheduled = False
        self._closed = False
        self.latency = metrics.Histogram("serve_request_latency_seconds",
                                         ring=_LAT_RING)
        self._staging = _Staging(pin_memory)
        self._staging_lock = threading.Lock()  # flushes and run_batch
        self.stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "rows": 0, "padded_rows": 0,
            "size_flushes": 0, "deadline_flushes": 0, "close_flushes": 0,
            "max_queue_depth": 0, "errors": 0, "h2d_transfers": 0,
        }

    # -- submission ----------------------------------------------------------
    def submit(self, x) -> PFuture:
        """Enqueue one example; resolves to its row of the prediction.
        Blocks while ``max_queue`` requests are already pending."""
        fut = PFuture()
        req = _Request(x, fut)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            while len(self._pending) >= self.max_queue:
                self._cond.wait(0.05)
                if self._closed:
                    raise RuntimeError("batcher is closed")
            self._pending.append(req)
            self.stats["requests"] += 1
            depth = len(self._pending)
            if depth > self.stats["max_queue_depth"]:
                self.stats["max_queue_depth"] = depth
            if not self._pump_scheduled:
                self._pump_scheduled = True
                self._exec.submit(self._pump_pid, self._pump)
            self._cond.notify_all()
        return fut

    # -- flush loop (runs on the executor worker) ----------------------------
    def _pump(self):
        while True:
            with self._cond:
                if not self._pending:
                    self._pump_scheduled = False
                    return
                deadline = self._pending[0].t_enqueue + self.max_wait
                while (not self._closed
                       and len(self._pending) < self.max_batch):
                    rem = deadline - clock.now()
                    if rem <= 0:
                        break
                    self._cond.wait(rem)
                if len(self._pending) >= self.max_batch:
                    reason = "size"
                elif self._closed:
                    reason = "close"
                else:
                    reason = "deadline"
                reqs = [self._pending.popleft()
                        for _ in range(min(len(self._pending),
                                           self.max_batch))]
                self._cond.notify_all()   # wake backpressured submitters
            if not reqs:    # close() raced the deadline wait and drained
                continue    # the queue itself; nothing to flush
            self._flush(reqs, reason)

    def run_batch(self, xs: List[Any]):
        """Stage ``xs`` (one example each) into their bucket's buffer,
        run ``predict_fn`` once and read the result back: the host-side
        result tree (leading axis the bucket) and the bucket. What a
        flush does, without its bookkeeping; it waits for a flush in
        progress, whose staging buffers it may share."""
        bucket = bucket_size(len(xs))
        with self._staging_lock:
            padded, bufs = self._staging.batch(xs, bucket)
            return _readback(self.predict_fn(padded), bufs), bucket

    def _flush(self, reqs: List[_Request], reason: str):
        self.stats[f"{reason}_flushes"] += 1
        self.stats["batches"] += 1
        self.stats["rows"] += len(reqs)
        try:
            before = h2d_copies()
            with _trace.span("serve.flush", "serve", reason=reason,
                             rows=len(reqs), bucket=bucket_size(len(reqs))):
                result, bucket = self.run_batch([r.x for r in reqs])
            self.stats["padded_rows"] += bucket - len(reqs)
            self.stats["h2d_transfers"] += h2d_copies() - before
            now = clock.now()
            for i, r in enumerate(reqs):
                self.latency.observe(now - r.t_enqueue)
                r.future._resolve(tree_map(lambda a, i=i: a[i], result))
        except BaseException as e:      # surfaced on each request's wait()
            self.stats["errors"] += 1
            for r in reqs:
                r.future._reject(e)

    # -- introspection -------------------------------------------------------
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def latencies_s(self) -> List[float]:
        return self.latency.values()

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._cond:
            out = dict(self.stats)
            out["queue_depth"] = len(self._pending)
            out["staging_builds"] = self._staging.builds
            out["staging_reuses"] = self._staging.reuses
        n = max(1, out["rows"] + out["padded_rows"])
        out["occupancy"] = out["rows"] / n
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Flush whatever is pending, then stop accepting requests and
        stop the executor (when it is the batcher's own)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._owns_executor:
            self._exec.shutdown(drain=True, timeout=timeout)
        # reject anything the pump never got to (executor already down)
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
        for r in leftovers:
            r.future._reject(RuntimeError("batcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class Generation:
    """Resolved result of one decode request (PFuture payload)."""
    prompt: List[int]
    tokens: List[int]                       # generated ids (incl. eos if hit)
    logprobs: List[float] = field(default_factory=list)   # BMA log p(token)
    entropy: List[float] = field(default_factory=list)    # total predictive
    mutual_info: List[float] = field(default_factory=list)  # epistemic part
    finish_reason: str = "length"           # "eos" | "length"
    preemptions: int = 0

    @property
    def text_ids(self) -> List[int]:
        return self.prompt + self.tokens


class _Seq:
    """One in-flight sequence. ``all_tokens`` (prompt + generated) is the
    whole decode state: the KV pool holds entries for ``all_tokens[:-1]``
    and the next step feeds ``all_tokens[-1]`` at position
    ``len(all_tokens) - 1`` — so preemption can drop every page and later
    rebuild them with one prefill over ``all_tokens[:-1]``."""
    __slots__ = ("sid", "prompt", "max_new", "eos_id", "future", "generated",
                 "logprobs", "entropy", "mutual_info", "t_enqueue",
                 "preemptions")

    def __init__(self, sid: int, prompt: List[int], max_new: int,
                 eos_id: Optional[int], future: PFuture):
        self.sid = sid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = future
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.entropy: List[float] = []
        self.mutual_info: List[float] = []
        self.t_enqueue = clock.now()
        self.preemptions = 0

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt + self.generated

    def finish_reason(self) -> Optional[str]:
        if self.generated and self.eos_id is not None \
                and self.generated[-1] == self.eos_id:
            return "eos"
        if len(self.generated) >= self.max_new:
            return "length"
        return None

    def result(self) -> Generation:
        return Generation(prompt=self.prompt, tokens=self.generated,
                          logprobs=self.logprobs, entropy=self.entropy,
                          mutual_info=self.mutual_info,
                          finish_reason=self.finish_reason() or "length",
                          preemptions=self.preemptions)


# store -> the scheduler serving it, read by runtime.backends' stats(). Weak
# values: a dropped scheduler is not kept alive by its stats hook.
_DECODE_SCHEDULERS: "weakref.WeakValueDictionary" = \
    weakref.WeakValueDictionary()


def decode_stats_for(store) -> Optional[Dict[str, Any]]:
    """The ``pd.stats()["decode"]`` section: the stats of the
    DecodeScheduler serving ``store``, None when none does."""
    sched = _DECODE_SCHEDULERS.get(id(store))
    return None if sched is None else sched.snapshot_stats()


class DecodeScheduler:
    """Continuous batching over a ``PagedDecodeEngine`` + ``PagePool``.

      admit    while rows are free and the pool can cover a waiting
               prompt's pages, pop it, prefill its prompt (padded to a
               pow2 bucket), seat it in a row;
      grow     a running row crossing a page boundary allocates its next
               page; if the pool is dry the YOUNGEST row is preempted;
      decode   one step for all seated rows (inactive rows ride along
               masked with seq_len -1);
      retire   rows hitting eos/max_new release pages and resolve their
               PFuture in the SAME iteration the row frees up.

    ``step_lock`` serializes steps against external store churn: a
    ``p_clone`` / ``p_kill`` made under it never meets a step's page
    checkout, and a clone copies its source's ``kv_pages`` row in place,
    so the clone holds the KV of every sequence in flight.
    """

    def __init__(self, engine, pool, *, max_active: int = 8,
                 eos_id: Optional[int] = None, max_queue: int = 256):
        if max_active < 1 or max_queue < 1:
            raise ValueError("max_active and max_queue must be >= 1")
        self.engine = engine
        self.pool = pool
        self.max_active = max_active
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.n_pmax = engine.n_pmax
        if pool.max_seq_pages != self.n_pmax:
            raise ValueError(
                f"pool.max_seq_pages ({pool.max_seq_pages}) must equal the "
                f"engine's block-table width n_pmax ({self.n_pmax})")
        self._exec = Executor(num_devices=1, pool_size=0,
                              max_pending=2 * max_queue)
        self._pump_pid = id(self)
        self._exec.add_particle(self._pump_pid, 0)
        self._cond = threading.Condition()
        self._waiting: deque = deque()
        self._rows: List[Optional[_Seq]] = [None] * max_active
        self._pump_scheduled = False
        self._closed = False
        self._next_sid = 0
        # submit->retire latency per sequence, newest _LAT_RING kept
        self.latency: deque = deque(maxlen=_LAT_RING)
        # fixed-shape decode staging buffer: [:, 0] token, [:, 1] seq_len,
        # [:, 2:] block table — refilled in place, ONE H2D per step
        self._packed = np.zeros((max_active, 2 + self.n_pmax), np.int32)
        self._prefill_bufs: Dict[int, np.ndarray] = {}
        self.step_lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "submitted": 0, "admitted": 0, "retired": 0, "preempted": 0,
            "steps": 0, "prefills": 0, "generated_tokens": 0,
            "active_row_steps": 0, "admission_blocked": 0,
            "h2d_transfers": 0, "errors": 0, "max_queue_depth": 0,
        }
        _DECODE_SCHEDULERS[id(engine.store)] = self

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, *, max_new: int,
               eos_id: Optional[int] = None) -> PFuture:
        """Enqueue one prompt (list/array of token ids); resolves to a
        ``Generation``. Blocks while ``max_queue`` sequences wait."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        ps = self.pool.page_size
        worst = len(prompt) + max_new
        limit = min(self.n_pmax, self.pool.num_pages) * ps
        if worst > limit:
            raise ValueError(
                f"prompt + max_new = {worst} tokens needs "
                f"{-(-worst // ps)} pages; pool/block-table limit is "
                f"{limit // ps} pages ({limit} tokens)")
        fut = PFuture()
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            while len(self._waiting) >= self.max_queue:
                self._cond.wait(0.05)
                if self._closed:
                    raise RuntimeError("scheduler is closed")
            seq = _Seq(self._next_sid, prompt, max_new,
                       self.eos_id if eos_id is None else eos_id, fut)
            self._next_sid += 1
            self._waiting.append(seq)
            self.stats["submitted"] += 1
            self.stats["max_queue_depth"] = max(self.stats["max_queue_depth"],
                                                len(self._waiting))
            if not self._pump_scheduled:
                self._pump_scheduled = True
                self._exec.submit(self._pump_pid, self._pump)
            self._cond.notify_all()
        return fut

    def warmup(self, prompt_buckets=()):
        """Run the decode step once with every row masked inactive, and one
        prefill per requested pow2 prompt bucket with zero tokens (their
        writes go to the scratch page): this captures each step's program
        (kernel builds and library handles included) before the first
        request, so admission, retirement and preemption within the warmed
        buckets capture nothing more."""
        with self.step_lock:
            self._packed[:, 0] = 0
            self._packed[:, 1] = -1
            self._packed[:, 2:] = 0
            _to_host(self.engine.decode_step(self._packed))
            for b in prompt_buckets:
                buf = self._prefill_buf(bucket_size(int(b)))
                buf[:] = 0          # n_tokens = 0: every write masked out
                _to_host(self.engine.prefill(buf))

    # -- scheduler loop (runs on the executor worker) ------------------------
    def _pump(self):
        while True:
            with self._cond:
                if not self._waiting and not any(self._rows):
                    self._pump_scheduled = False
                    self._cond.notify_all()
                    return
            try:
                with self.step_lock:
                    self._step()
            except Exception as e:
                # engine-level failure (not per-sequence): fail every
                # in-flight sequence rather than spin on a broken step
                self.stats["errors"] += 1
                self._fail_all(e)

    def _step(self):
        self._admit()
        active = [(i, s) for i, s in enumerate(self._rows) if s is not None]
        if not active:
            if self._waiting:     # admission blocked on a dry pool with
                time.sleep(1e-3)  # nothing decoding: don't spin hot
            return
        for i, seq in active:
            if self._rows[i] is seq:    # not preempted by an earlier row
                self._ensure_page(seq)
        active = [(i, s) for i, s in enumerate(self._rows) if s is not None]
        if not active:
            return
        with _trace.span("decode.step", "decode", rows=len(active)):
            self._packed[:, 0] = 0
            self._packed[:, 1] = -1
            self._packed[:, 2:] = 0
            for i, seq in active:
                self._packed[i, 0] = seq.all_tokens[-1]
                self._packed[i, 1] = len(seq.all_tokens) - 1
                self.pool.fill_block_row(seq.sid, self._packed[i, 2:])
            self.stats["h2d_transfers"] += 1
            heads = _to_host(self.engine.decode_step(self._packed))
        self.stats["steps"] += 1
        self.stats["active_row_steps"] += len(active)
        for i, seq in active:
            self._append_token(seq, heads, i)
            self._maybe_retire(i, seq)

    def _admit(self):
        ps = self.pool.page_size
        while True:
            with self._cond:
                if not self._waiting:
                    return
                try:
                    row = self._rows.index(None)
                except ValueError:
                    return
                seq = self._waiting[0]
                # initial admission prefills the prompt; re-admission after
                # preemption replays everything but the pending token
                n_pf = len(seq.prompt) if not seq.generated \
                    else len(seq.all_tokens) - 1
                if self.pool.alloc(seq.sid, -(-n_pf // ps)) is None:
                    self.stats["admission_blocked"] += 1
                    return                    # backpressure: pool is dry
                self._waiting.popleft()
                self._cond.notify_all()       # wake backpressured submitters
            try:
                heads = self._prefill(seq, n_pf)
            except Exception as e:
                self.stats["errors"] += 1
                self.pool.release(seq.sid)
                seq.future._reject(e)
                continue
            self._rows[row] = seq
            self.stats["admitted"] += 1
            _trace.instant("decode.admit", "decode", sid=seq.sid,
                           replay=bool(seq.generated))
            if not seq.generated:
                # the prefill head IS the first generated token; replays
                # discard it (greedy => it equals the token already held)
                self._append_token(seq, heads, 0)
                self._maybe_retire(row, seq)

    def _prefill_buf(self, bucket: int) -> np.ndarray:
        buf = self._prefill_bufs.get(bucket)
        if buf is None:
            buf = np.zeros((bucket + self.n_pmax + 1,), np.int32)
            self._prefill_bufs[bucket] = buf
        return buf

    def _prefill(self, seq: _Seq, n_pf: int):
        bucket = bucket_size(n_pf)
        with _trace.span("decode.prefill", "decode", sid=seq.sid,
                         tokens=n_pf, bucket=bucket):
            buf = self._prefill_buf(bucket)
            buf[:n_pf] = seq.all_tokens[:n_pf]
            buf[n_pf:bucket] = 0
            self.pool.fill_block_row(seq.sid,
                                     buf[bucket:bucket + self.n_pmax])
            buf[-1] = n_pf
            self.stats["prefills"] += 1
            self.stats["h2d_transfers"] += 1
            return _to_host(self.engine.prefill(buf))

    def _ensure_page(self, seq: _Seq, extra: int = 0) -> bool:
        """Make the page for ``seq``'s next write position resident, plus
        ``extra`` further positions (a speculative draft window writes
        through position ``len - 1 + extra``), preempting youngest rows
        while the pool is dry. False iff ``seq`` itself got preempted (it
        WAS the youngest)."""
        need = (len(seq.all_tokens) - 1 + extra) // self.pool.page_size + 1
        while len(self.pool.pages_of(seq.sid)) < need:
            if self.pool.alloc(seq.sid,
                               need - len(self.pool.pages_of(seq.sid))):
                _trace.instant("decode.grow", "decode", sid=seq.sid,
                               pages=need)
                return True
            victim = max((s for s in self._rows if s is not None),
                         key=lambda s: s.sid)
            self._preempt(victim)
            if victim is seq:
                return False
        return True

    def _preempt(self, seq: _Seq):
        self._rows[self._rows.index(seq)] = None
        self.pool.release(seq.sid)
        seq.preemptions += 1
        self.stats["preempted"] += 1
        _trace.instant("decode.preempt", "decode", sid=seq.sid,
                       tokens=len(seq.all_tokens))
        with self._cond:
            self._waiting.appendleft(seq)

    def _append_token(self, seq: _Seq, heads, i: int):
        seq.generated.append(int(heads["token"][i]))
        seq.logprobs.append(float(heads["logprob"][i]))
        seq.entropy.append(float(heads["entropy"][i]))
        seq.mutual_info.append(float(heads["mutual_info"][i]))
        self.stats["generated_tokens"] += 1

    def _maybe_retire(self, row: int, seq: _Seq):
        if seq.finish_reason() is None:
            return
        self._rows[row] = None
        self.pool.release(seq.sid)
        self.stats["retired"] += 1
        self.latency.append(clock.now() - seq.t_enqueue)
        _trace.instant("decode.retire", "decode", sid=seq.sid,
                       tokens=len(seq.generated),
                       reason=seq.finish_reason())
        seq.future._resolve(seq.result())

    def _fail_all(self, e: BaseException):
        for i, seq in enumerate(self._rows):
            if seq is not None:
                self._rows[i] = None
                self.pool.release(seq.sid)
                seq.future._reject(e)
        with self._cond:
            leftovers = list(self._waiting)
            self._waiting.clear()
            self._cond.notify_all()
        for seq in leftovers:
            self.pool.release(seq.sid)
            seq.future._reject(e)

    # -- introspection -------------------------------------------------------
    def queue_depth(self) -> int:
        """Sequences waiting for a row."""
        with self._cond:
            return len(self._waiting)

    def active_count(self) -> int:
        return sum(1 for s in self._rows if s is not None)

    def latencies_s(self) -> List[float]:
        return list(self.latency)

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._cond:
            out = dict(self.stats)
            out["queue_depth"] = len(self._waiting)
        out["active_seqs"] = self.active_count()
        out["max_active"] = self.max_active
        steps = max(1, out["steps"])
        out["row_occupancy"] = out["active_row_steps"] / (
            steps * self.max_active)
        out["pool"] = self.pool.snapshot_stats()
        out["kv_pages"] = self.engine.kv_page_info()
        # the speculative scheduler fills this section in
        out["speculative"] = None
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: float = 60.0):
        """Stop accepting, drain everything in flight (waiting sequences
        included), shut the pump."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._exec.shutdown(drain=True, timeout=timeout)
        with self._cond:
            leftovers = list(self._waiting)
            self._waiting.clear()
        for seq in leftovers:    # pump never got to them (executor down)
            seq.future._reject(RuntimeError("scheduler closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
