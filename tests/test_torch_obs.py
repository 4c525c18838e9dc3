"""The port's observability against the JAX package, on the CPU: the tests
of ``tests/test_obs.py`` on the port, with the reference's golden key sets.

  * ``pd.stats()``: every section's key set equals ``tests/test_obs.py``'s
    golden set and the reference's own stats, the decode section too;
    the service's latency keys; the faults F2-F6 one test each (the
    store's ``unstacks`` / ``device_puts``, the ``placement`` section, the
    ``decode`` section, ``"speculative": None``, ``per_device_bytes``);
  * the exporters: the same spans and metrics give the reference's Chrome
    trace JSON and Prometheus text, key for key and line for line;
  * per-program cost attribution. The reference compiles a program a
    second time to analyse it, on demand; the port counts it on its first
    run (a step that updates its state in place cannot run twice), so
    ``cost()`` is None before that run, and the FLOPs are the products'
    (``torch.utils.flop_counter``), where XLA's also count elementwise
    ops. The counted run gives the same bits as an uncounted one; each
    kernel wrapper's ``cost`` gives its bound's formula;
  * ``pd.obs()``: snapshot, trace dump and Prometheus text;
  * the span taxonomy of DESIGN.md §12: every span and instant against a
    run that should emit it (executor, store, runtime, serve, decode,
    bdl).
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.serve import serve_decode as jserve_decode
from repro.core import ParticleModule as JModule
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, SteinVGD
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.store import ParticleStore, Placement
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import (decode_attention, flash_attention,
                                 paged_decode_attention,
                                 paged_decode_window_attention, svgd_rbf,
                                 swag_moments)
from repro_torch.obs import Obs, device, export, metrics, summary, trace
from repro_torch.optim import sgd
from repro_torch.runtime import ProgramCache, specs
from repro_torch.serve import serve, serve_decode
from test_obs import GOLDEN
from test_torch_serve import _inits, _modules, _x


@pytest.fixture(autouse=True)
def _tracer_reset():
    """Tracing never leaks across tests."""
    yield
    trace.disable()
    trace.clear()


def _pd(n=3, backend="compiled", seed=0):
    _, tmod = _modules(_inits(n, seed))
    pd = PushDistribution(tmod, backend=backend, device="cpu")
    for _ in range(n):
        pd.p_create(sgd(0.1))
    return pd


# ---------------------------------------------------------------------------
# golden schema
# ---------------------------------------------------------------------------

def test_stats_golden_schema():
    """Every section of the port's ``pd.stats()`` has the golden key set
    of ``tests/test_obs.py`` and the reference's own, section by
    section; the placement section's values are the reference's
    single-device plan's."""
    x = _x(4)
    jmod, tmod = _modules(_inits(3))
    jpd = JPD(jmod, num_devices=1, backend="compiled")
    tpd = PushDistribution(tmod, backend="compiled", device="cpu")
    try:
        from repro.optim import sgd as jsgd
        for _ in range(3):
            jpd.p_create(jsgd(0.1))
            tpd.p_create(sgd(0.1))
        jpd.p_predict({"x": jnp.asarray(x)})
        tpd.p_predict({"x": torch.from_numpy(x)})
        jst, tst = jpd.stats(), tpd.stats()
        assert tst["backend"] == "compiled"
        assert set(tst) == set(jst)
        for section, keys in GOLDEN.items():
            assert set(tst[section]) == keys, section
            assert set(tst[section]) == set(jst[section]), section
        for k in ("mesh_shape", "mode", "particle_axis", "model_axis",
                  "model_axis_size", "reshards"):
            assert tst["placement"][k] == jst["placement"][k], k
        assert tst["placement"]["per_device_param_bytes"] == \
            jst["placement"]["per_device_param_bytes"] == 4 * 4 * (12 + 4)
        assert tst["obs"]["clock"] == "perf_counter"
        assert isinstance(tst["obs"]["tracing_enabled"], bool)
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_serve_stats_latency_keys_regression():
    """Every service stats key of the reference survives, and the
    percentiles are numpy's over the batcher's latencies."""
    pd = _pd()
    try:
        with serve(pd, kind="regress", max_batch=4, max_wait_ms=1.0) as svc:
            xs = _x(9)
            for i in range(9):
                svc.predict({"x": xs[i]})
            st = svc.stats()
            for k in ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
                      "requests_per_s", "requests", "batches", "rows",
                      "padded_rows", "size_flushes", "deadline_flushes",
                      "close_flushes", "max_queue_depth", "errors",
                      "h2d_transfers", "queue_depth", "staging_builds",
                      "staging_reuses", "occupancy", "engine"):
                assert k in st, k
            lat = svc.batcher.latencies_s()
            assert len(lat) == 9
            for q, key in ((50, "latency_p50_ms"), (95, "latency_p95_ms"),
                           (99, "latency_p99_ms")):
                want = float(np.percentile(np.asarray(lat), q)) * 1e3
                assert st[key] == pytest.approx(want)
            assert st["latency_p99_ms"] >= st["latency_p50_ms"] > 0.0
    finally:
        pd.cleanup()


TINY = dict(n_units=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
            d_ff=32, vocab_size=64, max_seq_len=64)
DECODE_KEYS = {"submitted", "admitted", "retired", "preempted", "steps",
               "prefills", "generated_tokens", "active_row_steps",
               "admission_blocked", "h2d_transfers", "errors",
               "max_queue_depth", "queue_depth", "active_seqs", "max_active",
               "row_occupancy", "pool", "kv_pages", "speculative"}


def _lm_pd(n=1, seed=0):
    """A CPU PD of the tiny qwen, its weights the reference's."""
    jcfg = jconfigs.get("qwen1.5-0.5b").replace(**TINY)
    tcfg = tconfigs.get("qwen1.5-0.5b").replace(**TINY)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    stacked = params_from_numpy(jax.tree.map(np.asarray, jax.vmap(
        lambda k: japi.init_params(k, jcfg))(keys)))
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(n):
        pd.p_create(params=tree_map(lambda a: a[p], stacked))
    return jcfg, tcfg, pd


def test_decode_stats_golden_schema():
    """``pd.stats()`` grows the decode section while a DecodeScheduler
    serves the store, with the reference's keys (tests/test_obs.py), and
    the reference's own decode section has the same keys."""
    jcfg, tcfg, pd = _lm_pd()
    try:
        svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                           max_active=2, warmup=False)
        try:
            g = svc.generate([3, 7, 11], max_new=3)
            assert len(g.tokens) == 3
            dec = pd.stats()["decode"]
            assert set(dec) == DECODE_KEYS
            assert set(dec["kv_pages"]) == {"key", "dtypes",
                                            "per_device_bytes"}
            assert dec["kv_pages"]["key"] == "kv_pages"
            assert dec["speculative"] is None
            assert device.pool_gauges(svc.scheduler.pool) == dec["pool"]
            st = svc.stats()
            assert st["latency_p99_ms"] >= st["latency_p50_ms"] > 0.0
            assert st["latency_p50_ms"] == pytest.approx(
                metrics.percentile(svc.scheduler.latencies_s(), 50) * 1e3)
        finally:
            svc.close()
    finally:
        pd.cleanup()
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1) as jpd:
        jpd.p_create()
        jsvc = jserve_decode(jpd, jcfg, num_pages=16, page_size=8,
                             max_active=2, warmup=False, decode_kernel=False)
        try:
            jsvc.generate([3, 7, 11], max_new=3)
            jdec = jpd.stats()["decode"]
        finally:
            jsvc.close()
    assert set(jdec) == DECODE_KEYS
    assert set(jdec["kv_pages"]) == set(dec["kv_pages"])


# ---------------------------------------------------------------------------
# faults F2-F6, one test each
# ---------------------------------------------------------------------------

def test_f2_store_counts_unstacks_and_device_puts():
    """F2: the store's stats carry ``unstacks`` (a row sliced out of a
    stacked tree: a read, a subset commit's rows) and ``device_puts``
    (re-placements onto a mesh: 0 on one device)."""
    store = ParticleStore(device="cpu")
    for pid in range(3):
        store.register(pid)
        store.write("params", pid, {"w": torch.full((2,), float(pid))})
    st = store.snapshot_stats()
    assert {"unstacks", "device_puts"} <= set(st)
    assert set(st) == GOLDEN["store"]
    store.stacked("params")
    before = store.snapshot_stats()["unstacks"]
    store.read("params", 1)
    assert store.snapshot_stats()["unstacks"] == before + 1
    store.commit("params", {"w": torch.zeros((2, 2))}, pids=[0, 2])
    assert store.snapshot_stats()["unstacks"] == before + 3
    assert store.snapshot_stats()["device_puts"] == 0


def test_f3_stats_has_the_placement_section():
    """F3: ``pd.stats()["placement"]`` reads the store's single-device
    ``Placement``; under a 2D plan it reports the mesh, the model axis
    and the bytes of the largest model shard (the particle axis on a mesh
    is ``tests/test_torch_placement.py``'s, the model axis
    ``tests/test_torch_placement2d.py``'s)."""
    pd = _pd()
    try:
        pl = pd.stats()["placement"]
        assert pl == {"mesh_shape": None, "mode": "tp",
                      "particle_axis": "data", "model_axis": "model",
                      "model_axis_size": 1,
                      "per_device_param_bytes": 3 * 4 * (12 + 4),
                      "reshards": 0}
        assert pd.placement == Placement() == pd.store.placement
    finally:
        pd.cleanup()
    from repro_torch.launch import make_mesh
    two = Placement(mesh=make_mesh((2, 2), ("data", "model"),
                                   devices=["cpu"] * 4))
    _, tmod = _modules(_inits(3))
    pd = PushDistribution(tmod, backend="compiled", device="cpu",
                          placement=two)
    try:
        for _ in range(3):
            pd.p_create(sgd(0.1))
        pd.store.stacked("params")
        pl = pd.stats()["placement"]
        assert pl["mesh_shape"] == {"data": 2, "model": 2}
        assert pl["model_axis_size"] == 2 and pl["mode"] == "tp"
        # 4 slots over 2 data positions; these params match no rule, so
        # each model position holds its 2 rows whole
        assert pl["per_device_param_bytes"] == 2 * 4 * (12 + 4)
        # the gauges cover every position (four logical CPU positions)
        assert [g["platform"] for g in pd.obs().snapshot()["devices"]] \
            == ["cpu"]
    finally:
        pd.cleanup()


def test_f4_stats_has_the_decode_section_while_serving():
    """F4: ``pd.stats()`` has a ``"decode"`` section while a
    DecodeScheduler serves the store (``decode_stats_for``), and none
    before one does."""
    from repro_torch.serve.batcher import decode_stats_for
    _, tcfg, pd = _lm_pd()
    try:
        assert "decode" not in pd.stats()
        assert decode_stats_for(pd.store) is None
        svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                           max_active=2, warmup=False)
        try:
            svc.generate([5, 9], max_new=2)
            assert pd.stats()["decode"]["retired"] == 1
        finally:
            svc.close()
    finally:
        pd.cleanup()


def test_f5_plain_scheduler_reports_speculative_none():
    """F5: the plain scheduler's stats carry ``"speculative": None``; the
    speculative scheduler fills the section in."""
    _, tcfg, pd = _lm_pd(2)
    try:
        for spec, kind in ((None, type(None)), (2, dict)):
            svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                               max_active=2, warmup=False, speculative=spec)
            try:
                svc.generate([5, 9, 4], max_new=3)
                assert isinstance(
                    svc.scheduler.snapshot_stats()["speculative"], kind)
            finally:
                svc.close()
    finally:
        pd.cleanup()


def test_f6_kv_pages_report_per_device_bytes():
    """F6: the page pool's gauge is ``per_device_bytes`` (the store's
    ``per_device_bytes(key)``, as the reference names both); ``nbytes``
    is gone."""
    _, tcfg, pd = _lm_pd()
    try:
        svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                           max_active=2, warmup=False)
        try:
            kv = svc.scheduler.snapshot_stats()["kv_pages"]
        finally:
            svc.close()
        # 16 pages + the scratch page, 8 slots, 1 kv head of 8, k and v,
        # one layer, one particle (capacity 1), fp32
        assert kv["per_device_bytes"] == 17 * 8 * 8 * 2 * 4
        assert kv["per_device_bytes"] == pd.store.per_device_bytes("kv_pages")
        assert not hasattr(pd.store, "nbytes")
    finally:
        pd.cleanup()


def test_per_device_bytes_reads_rows_before_a_stack():
    store = ParticleStore(device="cpu")
    for pid in range(2):
        store.register(pid)
        store.write("params", pid, {"w": torch.ones(3)})
    assert store.per_device_bytes("params") == 2 * 3 * 4      # the rows
    store.stacked("params")
    assert store.per_device_bytes("params") == 2 * 3 * 4      # the stack
    assert store.per_device_bytes("nope") == 0


# ---------------------------------------------------------------------------
# exporters, against the reference's
# ---------------------------------------------------------------------------

def _spans():
    tid = threading.get_ident()
    return [{"name": "work", "cat": "store", "t0": 1.0, "t1": 1.5, "tid": tid,
             "args": {"key": "params"}},
            {"name": "mark", "cat": "decode", "t0": 2.0, "t1": 2.0,
             "tid": tid, "args": {"sid": 7}},
            {"name": "bare", "cat": "runtime", "t0": 3.0, "t1": 3.25,
             "tid": tid + 1, "args": None}]


def test_chrome_trace_matches_the_reference():
    """The same spans and track names give the reference's trace-event
    JSON (timestamps against each package's own clock epoch)."""
    spans = _spans()
    names = {spans[0]["tid"]: "main-test-track"}
    got = export.chrome_trace(spans, names)
    want = jexport.chrome_trace(spans, names)
    from repro.obs import clock as jclock
    from repro_torch.obs import clock as tclock
    shift = (jclock.EPOCH - tclock.EPOCH) * 1e6
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert len(got["traceEvents"]) == len(want["traceEvents"]) == 4
    for g, w in zip(got["traceEvents"], want["traceEvents"]):
        assert set(g) == set(w)
        for k in g:
            if k == "ts":
                assert g[k] == pytest.approx(w[k] + shift, abs=1e-2)
            else:
                assert g[k] == w[k], k


def test_chrome_trace_structure_and_roundtrip(tmp_path):
    trace.clear()
    trace.enable()
    trace.TRACER.name_track("main-test-track")
    with trace.span("work", "store", key="params"):
        pass
    trace.instant("mark", "decode", sid=7)
    doc = export.chrome_trace()
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["args"]["name"] == "main-test-track"
               for e in evs)
    (ev,) = [e for e in evs if e["ph"] == "X"]
    assert ev["name"] == "work" and ev["cat"] == "store"
    assert ev["dur"] >= 0 and ev["ts"] >= 0
    assert ev["args"] == {"key": "params"}
    (inst,) = [e for e in evs if e["ph"] == "i"]
    assert inst["s"] == "t" and inst["args"] == {"sid": 7}
    path = export.dump_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def _registry(mod):
    reg = mod.Registry()
    reg.counter("reqs", route="a").inc(3)
    reg.gauge("depth").set(2)
    h = reg.histogram("lat_s")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    reg.register_collector("store", lambda: {"live": 4, "deep": {"a": 1}})
    return reg


def test_prometheus_text_matches_the_reference():
    extra = {"serve": {"p99 (ms)": 1.5, "name": "drop-me", "on": True,
                       "rows": [1, 2]}}
    got = export.prometheus_text(_registry(metrics), extra=extra)
    want = jexport.prometheus_text(_registry(jmetrics), extra=extra)
    assert got == want
    assert 'repro_reqs{route="a"} 3.0' in got
    assert 'repro_lat_s{quantile="0.5"} 0.2' in got
    assert "repro_serve_p99__ms_ 1.5" in got and "drop-me" not in got


# ---------------------------------------------------------------------------
# per-program cost attribution
# ---------------------------------------------------------------------------

def _stacked(n=3):
    return params_from_numpy({"w": np.stack([i["w"] for i in _inits(n)]),
                              "b": np.stack([i["b"] for i in _inits(n)])})


def test_program_cost_attribution():
    """Every entry exposes FLOPs, bytes accessed and per-device param
    bytes. The port counts at the first run: before it ``cost()`` is
    None (the reference would compile to analyse)."""
    _, tmod = _modules(_inits(3))
    cache = ProgramCache()
    stacked = _stacked()
    batch = {"x": torch.ones((4, 3))}
    mask = torch.ones(3)
    spec = specs.ensemble_predict(tmod.forward)
    prog = cache.program(spec, (stacked, batch, mask))
    (e,) = cache.program_costs()
    assert e["name"] == spec.name and e["cost"] is None
    assert e["num_particles"] == 3 and len(e["fingerprint"]) == 16
    int(e["fingerprint"], 16)
    assert e["param_bytes_per_device"] == 3 * (12 + 4) * 4
    assert prog.cost() is None                  # not run yet
    prog(stacked, batch, mask)
    cost = prog.cost()
    # the one product: einsum (4, 3) x (3, 3, 4) over 3 particles
    assert cost["flops"] == 2 * 4 * 3 * 4 * 3
    assert cost["bytes_accessed"] > 0
    assert cost["param_bytes_per_device"] == e["param_bytes_per_device"]
    assert cost["memory"]["argument_bytes"] == (3 * 16 + 12 + 3) * 4
    assert cost["memory"]["output_bytes"] == 4 * 4 * 4
    assert cost["memory"]["temp_bytes"] == 0
    assert cost["loop_aware"] == {"flops": cost["flops"],
                                  "bytes": cost["bytes_accessed"],
                                  "collectives": {}}
    assert prog.cost() is cost                  # memoized
    assert cache.program_costs()[0]["cost"] is cost
    assert cache.program_costs(compute=True)[0]["cost"] is cost
    assert {"graph", "capture_s", "pool_bytes"} <= set(e)


def test_program_costs_compute_assembles_every_run_program():
    _, tmod = _modules(_inits(2))
    cache = ProgramCache()
    stacked = _stacked(2)
    args = (stacked, {"x": torch.ones((2, 3))}, torch.ones(2))
    prog = cache.program(specs.ensemble_predict(tmod.forward), args)
    prog(*args)
    assert cache.program_costs()[0]["cost"] is None      # not asked yet
    assert cache.program_costs(compute=True)[0]["cost"]["flops"] > 0


def test_counted_first_run_gives_the_same_bits():
    """A train step's first run, counted, equals the same step run
    uncounted on a copy of the state, bit for bit."""
    _, tmod = _modules(_inits(3))
    opt = sgd(0.1)
    spec = specs.ensemble_step(tmod.loss, opt)
    x = torch.from_numpy(_x(5))
    batch = {"x": x, "y": torch.ones((5, 4))}
    mask = torch.ones(3)
    states = []
    for _ in range(2):
        params = _stacked()
        rows = [opt.init(tree_map(lambda a, i=i: a[i], params))
                for i in range(3)]
        states.append((params, tree_map(lambda *xs: torch.stack(xs),
                                        *rows)))
    prog = ProgramCache().program(spec, (*states[0], batch, mask))
    out_a = prog(*states[0], batch, mask)
    assert prog.cost()["flops"] > 0
    from repro_torch.runtime.program import BuildCtx
    with torch.no_grad():
        out_b = spec.make(BuildCtx(3, torch.device("cpu")))(
            *states[1], batch, mask)
    for a, b in zip(jax.tree.leaves(tree_map(np.asarray, out_a)),
                    jax.tree.leaves(tree_map(np.asarray, out_b))):
        assert np.array_equal(a, b)


def test_counting_sums_products_bytes_and_charges():
    a, b = torch.ones((4, 5)), torch.ones((5, 6))
    with device.counting() as count:
        c = a @ b                               # 2 * 4 * 5 * 6 FLOPs
        c.view(-1)                              # a view moves nothing
        torch.empty(1000)                       # an allocation neither
        device.charge(7, 11)
    assert count.flops == 2 * 4 * 5 * 6 + 7
    assert count.bytes == (20 + 30 + 24) * 4 + 11
    assert not device.counting_now()
    device.charge(1, 1)                         # no count open: dropped
    assert count.flops == 2 * 4 * 5 * 6 + 7


def test_kernel_costs_use_the_bound_formulas():
    """Each wrapper's ``cost`` on this call's data, the formula of the
    kernel's bound in chip_smoke.py."""
    P, B, H, KVH, hd, ps, n_pmax, NP = 2, 3, 4, 2, 8, 4, 5, 12
    q = torch.zeros((P, B, H, hd))
    pages = torch.zeros((P, NP, ps, KVH, hd))
    bt = torch.zeros((B, n_pmax), dtype=torch.int32)
    sl = torch.tensor([5, -1, 9], dtype=torch.int32)
    live, n_bt = 6 + 10, (5 // ps + 1) + (9 // ps + 1)
    assert paged_decode_attention.cost(q, pages, pages, bt, sl) == (
        4 * P * live * H * hd,
        P * live * KVH * hd * 2 * 4 + 2 * q.numel() * 4 + 4 * (n_bt + B))
    W = 3
    qw = torch.zeros((P, B, W, H, hd))
    pairs = sum(W * L + W * (W + 1) // 2 for L in (5, 9))
    live = (5 + W) + (9 + W)
    n_bt = sum((L + W - 1) // ps + 1 for L in (5, 9))
    assert paged_decode_window_attention.cost(qw, pages, pages, bt, sl) == (
        4 * P * pairs * H * hd,
        P * live * KVH * hd * 2 * 4 + 2 * qw.numel() * 4 + 4 * (n_bt + B))
    S = 7
    qf = torch.zeros((P, B, S, H, hd))
    kf = torch.zeros((P, B, S, KVH, hd))
    assert flash_attention.cost(qf, kf, kf) == (
        4 * P * B * H * hd * S * (S + 1) // 2,
        (qf.numel() * 2 + kf.numel() * 2) * 4)
    C = 6
    kc = torch.zeros((P, B, C, KVH, hd))
    pos = torch.tensor([[0, 1, -1, 3, -1, -1]] * B, dtype=torch.int32)
    assert decode_attention.cost(q, kc, kc, pos) == (
        4 * P * 3 * B * H * hd,
        P * 3 * B * KVH * hd * 2 * 4 + 2 * q.numel() * 4 + pos.numel() * 4)
    theta = torch.zeros((4, 10))
    mb = 4 * 10 * 4
    assert svgd_rbf.sqdist_cost(theta) == (2 * 4 * 4 * 10, mb)
    assert svgd_rbf.force_cost(theta) == (4 * 4 * 4 * 10, 3 * mb)
    assert swag_moments.moments_cost(theta, dev=theta) == (7 * 40, 6 * mb)
    assert swag_moments.moments_cost(theta) == (7 * 40, 5 * mb)
    assert swag_moments.diag_std_cost(theta) == (4 * 40, 3 * mb)


# ---------------------------------------------------------------------------
# device gauges and the pd.obs() front-end
# ---------------------------------------------------------------------------

def test_device_gauges_on_the_cpu():
    (d,) = device.device_gauges()
    assert d["platform"] == "cpu" and d["id"] == 0
    assert all(d[k] is None for k in ("bytes_in_use", "peak_bytes_in_use",
                                      "bytes_limit", "largest_alloc_size"))


def test_obs_front_end(tmp_path):
    pd = _pd()
    try:
        trace.enable()
        pd.p_predict({"x": torch.from_numpy(_x(4))})
        obs = pd.obs()
        assert isinstance(obs, Obs)
        snap = obs.snapshot(costs=True)
        assert set(snap) == {"stats", "devices", "store", "programs",
                             "trace"}
        assert snap["devices"][0]["platform"] == "cpu"
        sg = snap["store"]
        assert sg["live"] == 3 and sum(sg["live_mask"]) == 3
        assert sg["per_device_bytes"]["params"] == 4 * (12 + 4) * 4
        assert sg["per_particle_bytes"]["params"] == (12 + 4) * 4
        assert sg["dtypes"]["params"] == {"float32": 2}
        assert sg["precision"]["master"] == "float32"
        assert snap["trace"]["recorded"] > 0
        assert all(p["cost"] is not None for p in snap["programs"]
                   if p["name"] == "ensemble_predict")
        path = obs.dump_trace(str(tmp_path / "pd.json"))
        with open(path) as f:
            doc = json.load(f)
        assert any(e.get("ph") == "X" for e in doc["traceEvents"])
        assert len(obs.chrome_trace()["traceEvents"]) >= len(
            doc["traceEvents"])
        text = obs.prometheus()
        assert "repro_program_cache_hits" in text
        s = summary()
        assert s["tracing_enabled"] and s["spans_recorded"] > 0
    finally:
        pd.cleanup()


# ---------------------------------------------------------------------------
# the span taxonomy (DESIGN.md §12)
# ---------------------------------------------------------------------------

def _names():
    return {s["name"] for s in trace.snapshot()}


def test_runtime_and_store_spans():
    """A traced compiled predict: the p_creates' generation bumps, a cold
    capture then a hit, the program's span."""
    trace.clear()
    trace.enable()
    pd = _pd()
    try:
        x = torch.from_numpy(_x(4))
        pd.p_predict({"x": x})
        pd.p_predict({"x": x})
        spans = trace.snapshot()
        names = {s["name"] for s in spans}
        assert {"store.generation_bump", "runtime.lower", "cache.hit",
                "cache.miss", "program.ensemble_predict"} <= names
        prog = [s for s in spans if s["name"] == "program.ensemble_predict"]
        assert len(prog) == 2 and prog[0]["cat"] == "runtime"
        assert prog[0]["args"] == {"n": 4}
    finally:
        pd.cleanup()


def test_store_h2d_span():
    """A write whose leaves come from another device than the store's."""
    trace.enable()
    store = ParticleStore(device="meta")
    store.register(0)
    store.write("params", 0, {"w": torch.ones(2)})
    (s,) = [s for s in trace.snapshot() if s["name"] == "store.h2d"]
    assert s["cat"] == "store" and s["args"] == {"key": "params"}
    trace.clear()
    store.write("params", 0, {"w": torch.ones(2, device="meta")})
    assert "store.h2d" not in _names()


def test_executor_spans_emitted():
    trace.clear()
    trace.enable()
    pd = _pd(backend="nel")
    try:
        pd.p_predict({"x": torch.from_numpy(_x(4))})
        pd.drain(10.0)
        runs = [s for s in trace.snapshot() if s["name"] == "executor.run"]
        assert len(runs) >= 3 and all(s["cat"] == "executor" for s in runs)
        tracks = trace.TRACER.track_names()
        assert any(tracks.get(s["tid"], "").startswith("push-dev")
                   for s in runs)
    finally:
        pd.cleanup()


@pytest.mark.parametrize("backend", ["compiled", "nel"])
def test_bdl_epoch_spans(backend):
    """``bdl.epoch`` once an epoch, fused and on the NEL; the fused run
    through the store's checkout / commit window."""
    trace.clear()
    trace.enable()
    _, tmod = _modules(_inits(2))
    x = torch.from_numpy(_x(8))
    data = [{"x": x, "y": x @ torch.ones((3, 4))}]
    algo = DeepEnsemble(tmod, backend=backend, device="cpu")
    try:
        algo.bayes_infer(data, epochs=3, optimizer=sgd(0.1), num_particles=2)
        spans = trace.snapshot()
        epochs = [s for s in spans if s["name"] == "bdl.epoch"]
        assert [s["args"] for s in epochs] == [
            {"algo": "ensemble", "epoch": e} for e in range(3)]
        assert all(s["cat"] == "bdl" for s in epochs)
        if backend == "compiled":
            assert {"store.checkout", "store.commit"} <= _names()
    finally:
        algo.cleanup()


def test_svgd_leader_epoch_spans():
    trace.clear()
    trace.enable()
    _, tmod = _modules(_inits(3))
    x = torch.from_numpy(_x(8))
    data = [{"x": x, "y": x @ torch.ones((3, 4))}]
    algo = SteinVGD(tmod, device="cpu")
    try:
        algo.bayes_infer(data, epochs=2, num_particles=3)
        epochs = [s for s in trace.snapshot() if s["name"] == "bdl.epoch"]
        assert [s["args"]["epoch"] for s in epochs] == [0, 1]
        assert {s["args"]["algo"] for s in epochs} == {"svgd"}
    finally:
        algo.cleanup()


def test_serve_flush_span():
    trace.clear()
    trace.enable()
    pd = _pd()
    try:
        with serve(pd, kind="regress", max_batch=4, max_wait_ms=1.0) as svc:
            svc.predict({"x": _x(1)[0]})
        flush = [s for s in trace.snapshot() if s["name"] == "serve.flush"]
        assert flush and flush[0]["cat"] == "serve"
    finally:
        pd.cleanup()


def test_decode_spans_plain_and_preempting():
    """Plain decode on a pool small enough to preempt: every decode span
    and instant of the plain scheduler."""
    trace.clear()
    trace.enable()
    _, tcfg, pd = _lm_pd()
    rng = np.random.default_rng(1)
    try:
        svc = serve_decode(pd, tcfg, num_pages=8, page_size=4, max_active=3,
                           warmup=False)
        try:
            for h in [svc.generate_async(list(rng.integers(1, 64, 12)),
                                         max_new=8) for _ in range(3)]:
                h.result(300)
            assert svc.stats()["preempted"] > 0
        finally:
            svc.close()
        spans = trace.snapshot()
        names = {s["name"] for s in spans}
        assert {"decode.step", "decode.prefill", "decode.admit",
                "decode.grow", "decode.preempt", "decode.retire"} <= names
        assert {s["cat"] for s in spans if s["name"].startswith("decode.")} \
            == {"decode"}
    finally:
        pd.cleanup()


def test_decode_spans_speculative():
    """Speculative decode: ``decode.draft`` and ``decode.verify`` a step,
    a ``decode.rollback`` where a rejected tail gives a page back."""
    trace.clear()
    trace.enable()
    _, tcfg, pd = _lm_pd(2)
    rng = np.random.default_rng(2)
    try:
        svc = serve_decode(pd, tcfg, num_pages=32, page_size=2, max_active=3,
                           warmup=False, speculative=4)
        try:
            for h in [svc.generate_async(list(rng.integers(1, 64, 5)),
                                         max_new=10) for _ in range(3)]:
                h.result(300)
            rollback = svc.stats()["speculative"]["rollback_pages"]
        finally:
            svc.close()
        names = _names()
        assert {"decode.draft", "decode.verify"} <= names
        assert rollback > 0 and "decode.rollback" in names
    finally:
        pd.cleanup()
