"""The port's classification serving against the JAX package, on the CPU:
the tests of ``tests/test_serve.py`` run on both packages with the same
numpy inputs (the tiny linear module of that file, its weights made with
numpy and handed to both).

  * ``MicroBatcher``: size and deadline triggers, pad-to-bucket and
    slice-back, backpressure, error propagation, rejection after close,
    each run on both batchers with equal results and flush stats; the
    host-to-device copies counted where the programs issue them, per
    leaf, with size flushes only (no timing in the count), an extra copy
    or an eager move counted too, the staging buffers reused, and a
    consumer that hands back its input not overwritten by the next flush;
  * bucket and pad helpers; the engine's BMA against a per-particle loop
    (<1e-5) and against the reference engine; the bucketed program
    cache (compiles, hits, programs), no miss after warmup and none
    after a ``p_kill`` within capacity; store commits seen through the
    version; the stateful step; bad construction;
  * ``serve``: concurrent single-example requests against the
    reference's ``serve(...).predict``, the ``posterior_predictive``
    handoff with ``max_batch=``, ``predict_batch(members=)``, a static
    tree captured anew per ``posterior_predictive`` and its programs
    dropped by ``close``, the default warm-up on the first flush, the
    placement refusal, a precision preset resolved (a typo refused), a
    failing forward's error on every future;
  * metrics against the NumPy references and the reference's jnp
    metrics (1e-5, accuracy 1e-6), the calibrated-ECE case, degenerate
    heads, and the standalone heads against the reference's;
  * ``MultiSWAG.posterior_predictive`` serving samples (the reference's
    noise) against the reference's.

Left out: the checkpoint round trips (``tests/test_torch_checkpoint.py``
holds them) and the sharded subprocess check (its counterpart is
``tests/test_torch_placement.py``).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.optim import sgd as jsgd
from repro.runtime import ProgramCache as JProgramCache
from repro.serve import MicroBatcher as JMicroBatcher
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro.serve import bucket_size as jbucket_size
from repro.serve import metrics as jmetrics
from repro.serve import pad_rows as jpad_rows
from repro.serve import serve as jserve
from repro.serve import uncertainty as juncertainty
from repro_torch.bdl import DeepEnsemble, MultiSWAG
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.interop import params_from_numpy
from repro_torch.optim import sgd
from repro_torch.runtime import ProgramCache
from repro_torch.serve import (MicroBatcher, PredictiveEngine, bucket_size,
                               metrics, pad_rows, serve, uncertainty)
from test_torch_swag_serve import _reference_noise


def _inits(n, seed=0, out_dim=4):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((3, out_dim)).astype(np.float32),
             "b": (rng.standard_normal(out_dim) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _tfwd(p, b):
    return torch.einsum("bi,pio->pbo", b["x"], p["w"]) + p["b"][:, None]


def _modules(inits):
    """The linear module of tests/test_serve.py in both packages, each
    init handing out ``inits`` in order."""
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: (jnp.mean((b["x"] @ p["w"] + p["b"]
                                           - b["y"]) ** 2), {}),
                   lambda p, b: b["x"] @ p["w"] + p["b"])
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)),
                          lambda p, b: (((_tfwd(p, b) - b["y"]) ** 2)
                                        .mean((1, 2)), {}),
                          _tfwd)
    return jmod, tmod


def _pds(n, seed=0, capacity=0):
    jmod, tmod = _modules(_inits(n, seed))
    jpd = JPD(jmod, num_devices=1, capacity=capacity)
    tpd = PushDistribution(tmod, capacity=capacity, device="cpu")
    for _ in range(n):
        jpd.p_create(jsgd(0.1))
        tpd.p_create(sgd(0.1))
    return jpd, tpd


def _x(m, seed=1):
    return np.random.default_rng(seed).standard_normal((m, 3)).astype(
        np.float32)


def _close(got, want, tol, keys=None):
    for k in keys or want:
        err = np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
        assert err < tol, (k, err)


FLUSH_KEYS = ("requests", "batches", "rows", "padded_rows", "size_flushes",
              "deadline_flushes", "close_flushes", "errors")


def _same_flushes(a, b):
    sa, sb = a.snapshot_stats(), b.snapshot_stats()
    assert {k: sa[k] for k in FLUSH_KEYS} == {k: sb[k] for k in FLUSH_KEYS}
    return sa


# ---------------------------------------------------------------------------
# micro-batcher, on both packages
# ---------------------------------------------------------------------------

class _Recorder:
    """predict_fn double: records every padded batch it was handed."""

    def __init__(self, gate=None, fail=False):
        self.batches = []
        self.gate = gate
        self.fail = fail

    def __call__(self, batch):
        if self.gate is not None:
            assert self.gate.wait(10.0)
        if self.fail:
            raise RuntimeError("model exploded")
        self.batches.append({k: np.array(v) for k, v in batch.items()})
        return {"y": batch["x"] * 2.0}


BATCHERS = [(JMicroBatcher, jnp.asarray), (MicroBatcher, np.asarray)]


def test_batcher_size_trigger_flushes_full_batch():
    outs = []
    for cls, arr in BATCHERS:
        with cls(_Recorder(), max_batch=4, max_wait_ms=60_000) as mb:
            futs = [mb.submit({"x": arr(np.full((2,), float(i)))})
                    for i in range(4)]
            outs.append([np.asarray(f.wait(10.0)["y"]) for f in futs])
        st = mb.snapshot_stats()
        assert st["size_flushes"] == 1 and st["deadline_flushes"] == 0
        assert st["batches"] == 1 and st["requests"] == 4
    for i, (a, b) in enumerate(zip(*outs)):
        assert np.array_equal(a, b) and a[0] == 2.0 * i


def test_batcher_deadline_trigger():
    mbs = []
    for cls, arr in BATCHERS:
        with cls(_Recorder(), max_batch=64, max_wait_ms=50) as mb:
            t0 = time.monotonic()
            out = mb.submit({"x": arr(np.ones((2,)))}).wait(10.0)
            waited = time.monotonic() - t0
        assert float(out["y"][0]) == 2.0
        assert waited >= 0.04, "flushed before the deadline"
        st = mb.snapshot_stats()
        assert st["deadline_flushes"] == 1 and st["size_flushes"] == 0
        mbs.append(mb)
    _same_flushes(*mbs)


def test_batcher_pads_to_bucket_and_slices_back():
    recs, mbs = [], []
    for cls, arr in BATCHERS:
        rec = _Recorder()
        with cls(rec, max_batch=8, max_wait_ms=200) as mb:
            futs = [mb.submit({"x": arr(np.full((2,), float(i)))})
                    for i in range(3)]
            outs = [f.wait(10.0) for f in futs]
        # three requests ride one power-of-two padded batch ...
        (batch,) = rec.batches
        assert batch["x"].shape == (4, 2)
        assert batch["x"][3, 0] == 2.0          # pad = repeat of last row
        # ... and each caller gets exactly its own row back
        for i, o in enumerate(outs):
            assert o["y"].shape == (2,) and float(o["y"][0]) == 2.0 * i
        recs.append(rec)
        mbs.append(mb)
    assert np.array_equal(recs[0].batches[0]["x"], recs[1].batches[0]["x"])
    assert _same_flushes(*mbs)["padded_rows"] == 1


@pytest.mark.parametrize("cls,arr", BATCHERS, ids=["reference", "port"])
def test_batcher_backpressure_blocks_submitters(cls, arr):
    gate = threading.Event()
    mb = cls(_Recorder(gate=gate), max_batch=1, max_wait_ms=0, max_queue=2)
    try:
        futs = [mb.submit({"x": arr(np.zeros((1,)))}) for _ in range(3)]
        # the pump holds one request inside predict_fn; the queue is full
        done = threading.Event()

        def blocked_submit():
            futs.append(mb.submit({"x": arr(np.zeros((1,)))}))
            done.set()

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        assert not done.wait(0.3), "submit did not block on a full queue"
        gate.set()                      # unblock the model; queue drains
        assert done.wait(10.0), "backpressured submit never admitted"
        for f in futs:
            f.wait(10.0)
    finally:
        gate.set()
        mb.close()
    st = mb.snapshot_stats()
    assert st["max_queue_depth"] <= 2 and st["requests"] == 4
    assert st["queue_depth"] == 0


def test_batcher_propagates_model_errors():
    mbs = []
    for cls, arr in BATCHERS:
        with cls(_Recorder(fail=True), max_batch=2, max_wait_ms=10) as mb:
            f = mb.submit({"x": arr(np.zeros((1,)))})
            with pytest.raises(RuntimeError, match="model exploded"):
                f.wait(10.0)
        assert mb.snapshot_stats()["errors"] == 1
        mbs.append(mb)
    _same_flushes(*mbs)


@pytest.mark.parametrize("cls,arr", BATCHERS, ids=["reference", "port"])
def test_batcher_rejects_after_close(cls, arr):
    mb = cls(_Recorder(), max_batch=2, max_wait_ms=10)
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit({"x": arr(np.zeros((1,)))})


def _copy_to_meta(times=1):
    """A consumer that copies its staged batch into static inputs on a
    device ``times`` times, as a captured program does; the meta device
    stands in for the card (a copy to any device but the CPU counts)."""
    from repro_torch.runtime.program import _copy_into

    def fn(batch):
        static = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
        for _ in range(times):
            _copy_into(static, batch)
        return {"y": batch["x"] * 2.0}
    return fn


def test_batcher_staging_one_copy_per_leaf_per_flush():
    """Size flushes only (the deadline is a minute away), so the count
    cannot depend on timing: each flush stages its batch once, a repeated
    bucket reuses its buffers (the same tensors), rows never leak between
    flushes, and a flush counts the host-to-device copies its consumer's
    programs issued: one per leaf of its batch when the staged buffers go
    straight into static inputs, none for a consumer on the host (the
    reference counts one per flush: its batch has one leaf)."""
    for cls, arr in BATCHERS:
        rec = _Recorder()
        with cls(rec, max_batch=4, max_wait_ms=60_000) as mb:
            for _ in range(3):
                futs = [mb.submit({"x": arr(np.full((2,), float(i))),
                                   "z": arr(np.zeros((), np.int32))})
                        for i in range(4)]
                for f in futs:
                    f.wait(10.0)
        st = mb.snapshot_stats()
        assert st["batches"] == st["size_flushes"] == 3
        assert st["staging_builds"] == 1 and st["staging_reuses"] == 2
        for batch in rec.batches:
            assert np.array_equal(batch["x"][:, 0], [0, 1, 2, 3])
        if cls is MicroBatcher:
            assert st["h2d_transfers"] == 0
    with MicroBatcher(_copy_to_meta(), max_batch=4,
                      max_wait_ms=60_000) as mb:
        for _ in range(3):
            for f in [mb.submit({"x": np.full((2,), float(i), np.float32),
                                 "z": np.zeros((), np.int32)})
                      for i in range(4)]:
                f.wait(10.0)
    assert mb.snapshot_stats()["h2d_transfers"] == 3 * 2
    # the port's buffers are the same tensors flush after flush
    seen = []
    with MicroBatcher(lambda b: seen.append(b["x"]) or {"y": b["x"]},
                      max_batch=2, max_wait_ms=60_000) as mb:
        for r in range(2):
            for f in [mb.submit({"x": np.full(3, r + i, np.float32)})
                      for i in range(2)]:
                f.wait(10.0)
    assert seen[0] is seen[1] and not seen[0].is_pinned()


def test_batcher_counts_the_copies_its_consumer_issues():
    """The count comes from the copy sites, so it shows what a flush
    really moved: a second copy of the staged batch doubles it, and a
    consumer that moves the batch to the device itself (the eager path's
    ``_as_tensors``) counts each leaf it moved."""
    from repro_torch.runtime.program import _as_tensors

    def submit_pairs(mb, n):
        for f in [mb.submit({"x": np.zeros(2, np.float32)})
                  for _ in range(n)]:
            f.wait(10.0)
        return mb.snapshot_stats()

    with MicroBatcher(_copy_to_meta(times=2), max_batch=2,
                      max_wait_ms=60_000) as mb:
        st = submit_pairs(mb, 4)
    assert st["batches"] == 2 and st["h2d_transfers"] == 2 * 2

    def moved(batch):
        _as_tensors(batch, torch.device("meta"))
        return {"y": batch["x"] * 2.0}

    with MicroBatcher(moved, max_batch=2, max_wait_ms=60_000) as mb:
        st = submit_pairs(mb, 2)
    assert st["batches"] == 1 and st["h2d_transfers"] == 1


def test_batcher_results_survive_the_next_flush():
    """A consumer that hands back its input (a view of the reused staging
    buffer): each request keeps its own row after later flushes refill
    the buffer, and ``run_batch`` called beside the worker's flushes
    waits for them rather than sharing a buffer mid-flush."""
    with MicroBatcher(lambda b: {"y": b["x"]}, max_batch=2,
                      max_wait_ms=60_000) as mb:
        got = []
        for r in range(3):
            got += [mb.submit({"x": np.full(3, 10.0 * r + i, np.float32)})
                    for i in range(2)]
            for f in got[-2:]:
                f.wait(10.0)
        outs = [mb.run_batch([{"x": np.full(3, -1.0, np.float32)}] * 2)]
        for r in range(3):
            for i in range(2):
                assert np.array_equal(got[2 * r + i].wait(1.0)["y"],
                                      np.full(3, 10.0 * r + i)), (r, i)
        assert np.array_equal(outs[0][0]["y"], np.full((2, 3), -1.0))


def test_bucket_and_pad_helpers():
    ms = (1, 2, 3, 5, 8, 9)
    assert [bucket_size(m) for m in ms] == [jbucket_size(m) for m in ms] \
        == [1, 2, 4, 8, 8, 16]
    a = np.arange(6.0, dtype=np.float32).reshape(3, 2)
    t, jt = {"a": torch.from_numpy(a)}, {"a": jnp.asarray(a)}
    p = pad_rows(t, 8)
    assert p["a"].shape == (8, 2)
    assert np.array_equal(p["a"].numpy(), np.asarray(jpad_rows(jt, 8)["a"]))
    assert pad_rows(t, 3) is t


# ---------------------------------------------------------------------------
# engine: BMA parity, the bucketed program cache, store versioning
# ---------------------------------------------------------------------------

def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_fused_bma_matches_per_particle_loop():
    """The engine's BMA against a per-particle forward and a host-side
    average (<1e-5, both head kinds), and against the reference engine."""
    jpd, tpd = _pds(4)
    try:
        x = _x(7)
        member = np.stack([x @ p["w"] + p["b"] for p in _inits(4)])
        for kind in ("regress", "classify"):
            heads = PredictiveEngine(_tfwd, store=tpd.store,
                                     kind=kind).predict({"x": x})
            want = JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                     kind=kind).predict(
                                         {"x": jnp.asarray(x)})
            _close(heads, want, 1e-5)
            if kind == "regress":
                _close(heads, {"mean": member.mean(0),
                               "variance": member.var(0)}, 1e-5)
                continue
            probs = np.stack([_softmax(m) for m in member])
            mean = probs.mean(0)
            ent = -(mean * np.log(mean + 1e-12)).sum(-1)
            exp_ent = np.mean(-(probs * np.log(probs + 1e-12)).sum(-1), 0)
            _close(heads, {"mean": mean, "entropy": ent,
                           "expected_entropy": exp_ent,
                           "mutual_info": np.maximum(ent - exp_ent, 0)},
                   1e-5)
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_engine_bucketed_compile_cache():
    jpd, tpd = _pds(2)
    try:
        x = _x(8, seed=0)
        for eng, arr in (
                (PredictiveEngine(_tfwd, store=tpd.store, kind="regress"),
                 np.asarray),
                (JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                   kind="regress", cache=JProgramCache()),
                 jnp.asarray)):
            eng.predict({"x": arr(x[:3])})     # bucket 4: compile
            eng.predict({"x": arr(x[:4])})     # bucket 4: hit
            eng.predict({"x": arr(x[:5])})     # bucket 8: compile
            eng.predict({"x": arr(x[:8])})     # bucket 8: hit
            st = eng.snapshot_stats()
            assert st["compiles"] == 2 and st["bucket_hits"] == 2
            assert (st["programs"] if arr is jnp.asarray
                    else st["program_cache"]["programs"]) == 2
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_no_capture_after_warmup_nor_after_a_kill():
    """Warmup looks every bucket up once; traffic afterwards, a
    ``p_kill`` within capacity and traffic again miss nothing (the mask
    is a copied input), serve the live rows' BMA, equal to the
    reference's after the same kill, and leave the generation alone."""
    jpd, tpd = _pds(4, capacity=4)
    try:
        x = _x(16, seed=4)
        with serve(tpd, kind="classify", max_batch=8, max_wait_ms=1.0,
                   warmup={"x": x[0]}) as svc:
            cache = svc.engine.cache
            warm = cache.snapshot_stats()
            assert warm["misses"] == warm["cold_compiles"] == 4  # 1,2,4,8
            gen = tpd.store.generation()
            for f in [svc.predict_async({"x": r}) for r in x]:
                f.result(30.0)
            svc.predict_batch({"x": x[:5]})
            victim = tpd.particle_ids()[1]
            tpd.p_kill(victim)
            jpd.p_kill(jpd.particle_ids()[1])
            got = [svc.predict_async({"x": r}) for r in x[:8]]
            got = np.stack([f.result(30.0).mean for f in got])
            heads = svc.predict_batch({"x": x[:8]})
            st = cache.snapshot_stats()
            assert st["misses"] == warm["misses"]
            assert st["cold_compiles"] == warm["cold_compiles"]
            assert tpd.store.generation() == gen
            want = JPredictiveEngine(
                jpd.module.forward, store=jpd.store,
                kind="classify").predict({"x": jnp.asarray(x[:8])})
            _close(heads, want, 1e-5)
            assert np.abs(got - np.asarray(want["mean"])).max() < 1e-5
            assert svc.stats()["errors"] == 0
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_engine_sees_store_commits_via_version():
    _, tpd = _pds(2)
    try:
        eng = PredictiveEngine(_tfwd, store=tpd.store, kind="regress")
        x = np.ones((2, 3), np.float32)
        before = eng.predict({"x": x})["mean"].numpy()
        new = {k: torch.zeros_like(v)
               for k, v in tpd.store.stacked("params").items()}
        tpd.store.commit("params", new)
        after = eng.predict({"x": x})["mean"].numpy()
        assert np.abs(after).max() == 0.0 and np.abs(before).max() > 0.0
        st = eng.snapshot_stats()
        assert st["param_refreshes"] == 2
        # a commit that replaces the tree gives new addresses: a new program
        assert st["compiles"] == 2
    finally:
        tpd.cleanup()


def test_engine_stateful_step_matches_per_particle_loop():
    inits = _inits(3)
    _, tpd = _pds(3)
    try:
        def fwd(p, state, batch):
            out = _tfwd(p, batch) + state["acc"][:, None, None]
            state["acc"].add_(1.0)
            return out, state

        eng = PredictiveEngine(fwd, store=tpd.store, kind="regress",
                               stateful=True)
        with pytest.raises(RuntimeError):
            eng.predict({"x": np.ones((1, 3), np.float32)})
        state = eng.init_state(
            lambda p: {"acc": torch.zeros(p["w"].shape[0])})
        assert state["acc"].shape[0] == tpd.store.capacity == 4
        x = _x(4, seed=6)
        member = np.stack([x @ p["w"] + p["b"] for p in inits])
        for step in range(3):
            heads, state = eng.step(state, {"x": torch.from_numpy(x)})
            assert np.abs(heads["mean"].numpy()
                          - (member + step).mean(0)).max() < 1e-5
        assert float(state["acc"][0]) == 3.0
        st = eng.snapshot_stats()
        assert st["compiles"] == 1 and st["bucket_hits"] == 2
    finally:
        tpd.cleanup()


def test_engine_rejects_bad_construction():
    _, tpd = _pds(1)
    try:
        with pytest.raises(ValueError):
            PredictiveEngine(_tfwd)                     # no source
        with pytest.raises(ValueError):
            PredictiveEngine(_tfwd, store=tpd.store,
                             params=tpd.store.stacked("params"))
        with pytest.raises(ValueError):
            PredictiveEngine(_tfwd, store=tpd.store, kind="nope")
        eng = PredictiveEngine(_tfwd, store=tpd.store)
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.predict({"x": np.ones((1, 3), np.float32)})
    finally:
        tpd.cleanup()


# ---------------------------------------------------------------------------
# service front-end
# ---------------------------------------------------------------------------

def test_service_concurrent_requests_end_to_end():
    jpd, tpd = _pds(3)
    try:
        x = _x(16, seed=2)
        member = np.stack([x @ p["w"] + p["b"] for p in _inits(3)])
        want = member.mean(0)
        results = {"port": {}, "reference": {}}
        with serve(tpd, kind="regress", max_batch=8, max_wait_ms=5.0,
                   warmup={"x": x[0]}) as svc, \
                jserve(jpd, kind="regress", max_batch=8,
                       max_wait_ms=5.0) as jsvc:
            jsvc.predict_batch({"x": x[:8]})    # warm the bucket-8 program

            def client(i):
                results["port"][i] = svc.predict({"x": x[i]}, timeout=30.0)
                results["reference"][i] = jsvc.predict(
                    {"x": jnp.asarray(x[i])}, timeout=30.0)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            for i in range(16):
                p, r = results["port"][i], results["reference"][i]
                assert isinstance(p.mean, np.ndarray)
                assert np.abs(p.mean - want[i]).max() < 1e-5
                for k in ("mean", "variance", "entropy", "mutual_info"):
                    assert np.abs(getattr(p, k) - np.asarray(getattr(r, k))
                                  ).max() < 1e-5, k
            st = svc.stats()
            assert st["requests"] == 16 and st["errors"] == 0
            assert st["batches"] < 16, "no coalescing happened"
            assert st["latency_p99_ms"] >= st["latency_p50_ms"] >= 0.0
            assert st["requests_per_s"] > 0 and st["queue_depth"] == 0
            for k in ("size_flushes", "deadline_flushes", "close_flushes",
                      "staging_builds", "staging_reuses", "occupancy",
                      "padded_rows", "h2d_transfers", "max_queue_depth"):
                assert k in st and k in jsvc.stats(), k
            # on the CPU nothing crosses to a device
            assert st["h2d_transfers"] == 0
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_service_rejects_what_is_not_ported_and_reports_errors():
    _, tpd = _pds(2)
    try:
        # a placement other than the store's moves the store onto it
        # (one reshard, a new generation) and serves the same heads there
        from repro_torch.core.store import Placement, Sharded
        from repro_torch.launch import make_bench_mesh
        x = {"x": _x(3, seed=4)}
        with serve(tpd, warmup=False) as svc:
            want = svc.predict_batch(x)
        mesh = Placement(mesh=make_bench_mesh(2, devices=["cpu"] * 2))
        gen = tpd.store.generation()
        with serve(tpd, placement=mesh, warmup=False) as svc:
            assert svc.engine.placement == mesh == tpd.store.placement
            assert isinstance(tpd.store.stacked("params"), Sharded)
            got = svc.predict_batch(x)
        assert tpd.store.generation() == gen + 1
        with serve(tpd, placement=Placement(), warmup=False) as svc:
            assert not isinstance(tpd.store.stacked("params"), Sharded)
            back = svc.predict_batch(x)
        for k in want:
            assert (got[k] - want[k]).abs().max() < 1e-6, k
            assert torch.equal(back[k], want[k]), k
        # the precision ladder is ported: a preset resolves, a typo raises
        with serve(tpd, precision="bf16", warmup=False) as svc:
            assert svc.engine.precision.master == torch.bfloat16
        with pytest.raises(ValueError, match="unknown precision preset"):
            serve(tpd, precision="fp8", warmup=False)

        def broken(p, b):
            raise RuntimeError("forward exploded")

        with serve(tpd, forward=broken, warmup=False,
                   max_batch=2, max_wait_ms=60_000) as svc:
            futs = [svc.predict_async({"x": np.zeros(3, np.float32)})
                    for _ in range(2)]
            for f in futs:
                with pytest.raises(RuntimeError, match="forward exploded"):
                    f.result(10.0)
            assert svc.stats()["errors"] == 1
    finally:
        tpd.cleanup()


def test_default_warmup_captures_every_bucket_on_the_first_flush():
    """``serve(pd)`` with no example (the default ``warmup=True``: the
    module gives none) captures nothing up front; its first flush looks
    every bucket up to ``max_batch``'s up on its first row before it
    runs, later flushes miss nothing, and the heads equal the
    reference's."""
    jpd, tpd = _pds(3)
    try:
        x = _x(8, seed=6)
        with serve(tpd, max_batch=4, max_wait_ms=60_000) as svc:
            assert svc.engine.stats["compiles"] == 0
            futs = [svc.predict_async({"x": r}) for r in x]
            got = np.stack([f.result(30.0).mean for f in futs])
            assert svc.engine.stats["compiles"] == 3      # buckets 1, 2, 4
            assert svc.stats()["size_flushes"] == 2
        want = JPredictiveEngine(jpd.module.forward, store=jpd.store
                                 ).predict({"x": jnp.asarray(x)})["mean"]
        assert np.abs(got - np.asarray(want)).max() < 1e-5
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_predict_batch_members_are_the_live_rows():
    jpd, tpd = _pds(3, capacity=4)
    try:
        x = _x(5, seed=8)
        with serve(tpd, max_batch=4, warmup=False) as svc:
            tpd.p_kill(tpd.particle_ids()[0])
            jpd.p_kill(jpd.particle_ids()[0])
            heads, outs = svc.predict_batch({"x": x}, members=True)
            jh, jouts = JPredictiveEngine(
                jpd.module.forward, store=jpd.store).predict(
                    {"x": jnp.asarray(x)}, members=True)
            assert tuple(outs.shape) == (2, 5, 4)
            assert np.abs(outs.numpy() - np.asarray(jouts)).max() < 1e-5
            _close(heads, jh, 1e-5)
            names = sorted(p["name"] for p in svc.engine.cache.program_costs())
            assert names == ["bma_predict"]     # members: a spec of its own
            svc.predict_batch({"x": x})
            assert len(svc.engine.cache) == 2
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_infer_posterior_predictive_handoff():
    jmod, tmod = _modules(_inits(2, seed=3) * 2)
    x = _x(8, seed=3)
    data = [{"x": x, "y": x @ np.ones((3, 4), np.float32)}]
    with JDeepEnsemble(jmod, num_devices=1, seed=0,
                       backend="compiled") as jde, \
            DeepEnsemble(tmod, seed=0, backend="compiled",
                         device="cpu") as de:
        jde.bayes_infer([{k: jnp.asarray(v) for k, v in data[0].items()}],
                        2, optimizer=jsgd(0.05), num_particles=2)
        de.bayes_infer(data, 2, optimizer=sgd(0.05), num_particles=2)
        with de.posterior_predictive(kind="regress", max_batch=4,
                                     max_wait_ms=1.0,
                                     warmup={"x": x[0]}) as svc, \
                jde.posterior_predictive(kind="regress",
                                         max_wait_ms=1.0) as jsvc:
            assert svc.batcher.max_batch == 4
            assert len(svc.engine.cache) == 3          # buckets 1, 2, 4
            pred = svc.predict({"x": x[0]})
            jpred = jsvc.predict({"x": jnp.asarray(x[0])})
            assert np.abs(pred.mean - np.asarray(jpred.mean)).max() < 1e-5
            want = np.mean([x[:1] @ p["w"].numpy() + p["b"].numpy()
                            for p in de.p_parameters()], 0)[0]
            assert np.abs(pred.mean - want).max() < 1e-5


# ---------------------------------------------------------------------------
# calibration metrics and heads
# ---------------------------------------------------------------------------

def test_metrics_match_numpy_and_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 10)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, 10, 64)
    p32 = probs.astype(np.float32)
    for name, tol in (("nll", 1e-5), ("brier", 1e-5), ("accuracy", 1e-6)):
        got = float(getattr(metrics, name)(probs, labels))
        assert abs(got - getattr(metrics, f"{name}_ref")(probs, labels)) < tol
        got32 = float(getattr(metrics, name)(torch.from_numpy(p32),
                                             torch.from_numpy(labels)))
        assert abs(got32 - float(getattr(jmetrics, name)(
            jnp.asarray(p32), jnp.asarray(labels)))) < tol
    for n_bins in (5, 15):
        assert abs(float(metrics.ece(probs, labels, n_bins))
                   - metrics.ece_ref(probs, labels, n_bins)) < 1e-5
        assert abs(float(metrics.ece(p32, labels, n_bins))
                   - float(jmetrics.ece(jnp.asarray(p32),
                                        jnp.asarray(labels), n_bins))) < 1e-5
    rep = metrics.calibration_report(p32, labels)
    jrep = jmetrics.calibration_report(jnp.asarray(p32), jnp.asarray(labels))
    assert set(rep) == set(jrep)
    for k in rep:
        assert isinstance(rep[k], float) and abs(rep[k] - jrep[k]) < 1e-5
    assert metrics.nll_ref is not jmetrics.nll_ref      # a copy, not shared


def test_ece_bins_match_the_reference_at_bin_edges():
    """Confidences exactly on bin edges (and 0) land in the reference's
    bins: ``ceil(conf * n) - 1``, clamped."""
    conf = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 0.5, 0.25], np.float32)
    probs = np.stack([conf, 1.0 - conf], -1)
    probs = np.where(probs.max(-1, keepdims=True) == probs, probs, 0.0)
    labels = np.array([0, 1, 0, 1, 0, 0, 1, 1])
    for n_bins in (5, 4):
        assert abs(float(metrics.ece(probs, labels, n_bins))
                   - float(jmetrics.ece(jnp.asarray(probs),
                                        jnp.asarray(labels), n_bins))) < 1e-6


def test_metrics_calibrated_model_has_low_ece():
    rng = np.random.default_rng(1)
    n, conf = 4096, 0.7
    probs = np.full((n, 2), 0.0)
    probs[:, 0], probs[:, 1] = conf, 1 - conf
    labels = (rng.random(n) > conf).astype(np.int64)   # P(correct) = conf
    assert float(metrics.ece(probs, labels)) < 0.05
    labels_wrong = (rng.random(n) > 0.2).astype(np.int64)
    assert float(metrics.ece(probs, labels_wrong)) > 0.3


def test_uncertainty_heads_degenerate_cases():
    logits = torch.tensor([2.0, 0.0, -1.0]).expand(4, 5, 3)
    h = uncertainty.predictive_heads(logits, "classify")
    assert float(h["mutual_info"].max()) < 1e-6
    assert float(h["variance"].max()) < 1e-12
    outs = torch.stack([torch.zeros(5, 2), torch.ones(5, 2)])
    h = uncertainty.predictive_heads(outs, "regress")
    assert float((h["mean"] - 0.5).abs().max()) == 0.0
    assert float((h["variance"] - 0.25).abs().max()) == 0.0


def test_standalone_heads_match_the_reference():
    z = np.random.default_rng(5).standard_normal((4, 6, 5)).astype(
        np.float32) * 2.0
    t, j = torch.from_numpy(z), jnp.asarray(z)
    for name in ("bma_mean_probs", "expected_entropy", "mutual_information"):
        got = getattr(uncertainty, name)(t).numpy()
        want = np.asarray(getattr(juncertainty, name)(j))
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-5
    probs = torch.softmax(t, -1)
    assert np.abs(uncertainty.particle_variance(probs).numpy() - np.asarray(
        juncertainty.particle_variance(jax.nn.softmax(j, -1)))).max() < 1e-6
    # the heads agree with the in-program ones
    h = uncertainty.predictive_heads(t, "classify")
    assert torch.allclose(h["mean"], uncertainty.bma_mean_probs(t))
    assert torch.allclose(h["mutual_info"],
                          uncertainty.mutual_information(t), atol=1e-6)
    assert torch.allclose(h["variance"],
                          uncertainty.particle_variance(probs), atol=1e-7)


# ---------------------------------------------------------------------------
# MultiSWAG serving samples
# ---------------------------------------------------------------------------

def test_multiswag_posterior_predictive_serves_samples():
    inits = _inits(2, seed=5)
    jmod, tmod = _modules(inits)
    x = _x(8, seed=5)
    data = {"x": x, "y": x @ np.ones((3, 4), np.float32)}
    with JMultiSWAG(jmod, num_devices=1, seed=0, backend="compiled") as jms, \
            MultiSWAG(tmod, seed=0, backend="compiled", device="cpu") as ms:
        jms.bayes_infer([{k: jnp.asarray(v) for k, v in data.items()}], 3,
                        optimizer=jsgd(0.05), num_particles=2, max_rank=3)
        ms.bayes_infer([data], 3, optimizer=sgd(0.05), num_particles=2,
                       max_rank=3)
        rng = jax.random.PRNGKey(0)
        noise = _reference_noise(jms.store.dense("swag"), rng, 3)
        with jms.posterior_predictive(samples_per_particle=3, rng=rng,
                                      kind="regress",
                                      max_wait_ms=1.0) as jsvc, \
                ms.posterior_predictive(
                    samples_per_particle=3, kind="regress", max_batch=8,
                    max_wait_ms=1.0, warmup={"x": x[0]},
                    noise=(params_from_numpy(noise[0]),
                           torch.from_numpy(noise[1]))) as svc:
            assert svc.engine.num_particles == 6
            _close(svc.predict_batch({"x": x}),
                   jsvc.predict_batch({"x": jnp.asarray(x)}), 1e-4)
            one = svc.predict({"x": x[3]}, timeout=30.0)
            assert np.abs(one.mean - svc.predict_batch({"x": x})["mean"][3]
                          .numpy()).max() < 1e-5
        # S = 0 serves the live particle params
        with ms.posterior_predictive(kind="regress", warmup=False) as svc:
            assert svc.engine.num_particles == 2


def test_a_new_static_tree_captures_anew_and_close_drops_it():
    """Each ``posterior_predictive`` call samples a new static tree: its
    programs are keyed on the new addresses (a lookup against the old
    tree's programs never hits), and ``close`` empties the engine's own
    cache and lets the tree go."""
    jmod, tmod = _modules(_inits(2, seed=6))
    x = _x(8, seed=6)
    data = [{"x": x, "y": x @ np.ones((3, 4), np.float32)}]
    with MultiSWAG(tmod, seed=0, backend="compiled", device="cpu") as ms:
        ms.bayes_infer(data, 2, optimizer=sgd(0.05), num_particles=2,
                       max_rank=3)
        a = ms.posterior_predictive(samples_per_particle=2, kind="regress",
                                    max_batch=2, warmup={"x": x[0]})
        b = ms.posterior_predictive(samples_per_particle=2, kind="regress",
                                    max_batch=2, warmup={"x": x[0]},
                                    cache=a.engine.cache)
        st = a.engine.cache.snapshot_stats()
        assert st["cold_compiles"] == 4 and st["hits"] == 0
        shared = a.engine.cache
        b.close()           # a passed-in cache belongs to its caller ...
        assert b.engine._static_params is None
        # ... which drops b's programs once b's freed tree is gone
        assert len(shared) == 2 and shared.released == 2
        a.close()
        assert len(shared) == 0 and a.engine._static_params is None
        with pytest.raises(RuntimeError):
            a.predict({"x": x[0]})
