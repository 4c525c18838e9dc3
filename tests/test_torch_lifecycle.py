"""The port's particle lifecycle against the JAX package, on the CPU.

Ports the tests of ``tests/test_lifecycle.py`` (DESIGN.md §9): both
packages get the same particles, made from a seed with numpy (the tiny
linear module of that file; the reference's 2-layer tiny qwen for the
decode tests, initialized by the reference and carried over as numpy).

  * clone / kill semantics: a jitter-free clone equal bit for bit, in both
    packages; a jittered one nearby (0 < diff < 1: torch's and JAX's
    random streams differ, so there is no cross-package equality); extra
    state keys copied; a freed slot reused with no generation bump; the
    NEL's active set cleaned; one bump per doubling; ``p_rebalance()``
    is ``{}`` on one device; the lifecycle counters;
  * a clone is a copy inside the stacked tensors: every leaf keeps its
    ``data_ptr()``, and training the source on leaves the clone as it was;
  * masked heads and the masked SVGD force against dense subsets (<1e-5),
    and the masked fused SVGD step freezing dead slots, against the
    reference's;
  * ``p_predict``, ``PredictiveEngine.predict`` (also ``members=True``),
    paged and speculative ``serve_decode`` after churn: equal to the
    reference (tokens exactly), with no miss in the program cache after
    warmup (on the CPU the capturer is ``eager``: a miss is what a
    capture would be on the card) and no generation bump; killing the
    drafting particle re-picks the draft slot;
  * fused DeepEnsemble training after churn reusing its program, against
    the reference's fused run on the same particles;
  * ``bdl.lifecycle``: ``systematic_counts`` equal to the reference's for
    the same seed, ``ensemble_weights``, ``resample`` / ``grow`` /
    ``prune``;
  * the store's churn windows: slot activation on the first write, a
    mid-run register across a commit, a clone during a checkout failing
    loudly, growth during a checkout.

Left for a later queue item: the checkpoint round trip across capacities
(item 8). The bf16 serving tests run in ``tests/test_torch_precision.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import lifecycle as jlifecycle
from repro.bdl.svgd import fused_svgd_step as jfused_svgd_step
from repro.bdl.svgd import svgd_force as jsvgd_force
from repro.core import ParticleModule as JModule
from repro.core import ParticleStore as JParticleStore
from repro.core import PushDistribution as JPD
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro.serve import serve_decode as jserve_decode
from repro.serve.uncertainty import predictive_heads as jpredictive_heads
from repro_torch.bdl import DeepEnsemble, lifecycle
from repro_torch.bdl.svgd import fused_svgd_step, svgd_force
from repro_torch.core import ParticleModule, ParticleStore, PushDistribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.optim import sgd
from repro_torch.runtime import ProgramCache
from repro_torch.serve import PredictiveEngine, serve_decode
from repro_torch.serve.uncertainty import predictive_heads
from test_torch_speculative import _cfgs as _lm_cfgs
from test_torch_speculative import _jax_stacked, _to_port


# ---------------------------------------------------------------------------
# the tiny linear module of tests/test_lifecycle.py, in both packages
# ---------------------------------------------------------------------------

def _inits(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((3, 4)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(4) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _tfwd(p, b):
    return torch.einsum("bi,pij->pbj", b[0], p["w"]) + p["b"][:, None]


def _modules(inits):
    """A reference and a port module whose inits hand out ``inits`` in
    order (each package its own iterator)."""
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: (jnp.mean((b[0] @ p["w"] + p["b"]
                                           - b[1]) ** 2), {}),
                   lambda p, b: b[0] @ p["w"] + p["b"])
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)),
                          lambda p, b: (((_tfwd(p, b) - b[1]) ** 2)
                                        .mean((1, 2)), {}),
                          _tfwd)
    return jmod, tmod


def _batch(m=8, seed=3):
    x = np.random.default_rng(seed).standard_normal((m, 3)).astype(
        np.float32)
    return x, x @ np.ones((3, 4), np.float32)


def _jb(b):
    return tuple(jnp.asarray(x) for x in b)


def _tb(b):
    return tuple(torch.from_numpy(np.array(x)) for x in b)


def _pds(n, *, capacity=4, backend="nel", seed=0):
    """(reference PD, port PD on the CPU), each with n particles from the
    same numpy inits, sgd(0.1)."""
    jmod, tmod = _modules(_inits(n, seed))
    jpd = JPD(jmod, num_devices=1, capacity=capacity, backend=backend)
    tpd = PushDistribution(tmod, capacity=capacity, backend=backend,
                           device="cpu")
    for _ in range(n):
        jpd.p_create(jsgd(0.1))
        tpd.p_create(sgd(0.1))
    tpd.runtime.cache = ProgramCache()
    return jpd, tpd


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def _misses(pd):
    return pd.runtime.cache.snapshot_stats()["misses"]


# ---------------------------------------------------------------------------
# clone / kill semantics
# ---------------------------------------------------------------------------

def test_clone_identical_without_jitter_and_perturbed_with():
    jpd, tpd = _pds(1)
    with jpd, tpd:
        for pd in (jpd, tpd):
            src = pd.particle_ids()[0]
            twin = pd.p_clone(src)                  # jitter 0: exact copy
            assert twin != src
            a, b = _np(pd.p_params(src)), _np(pd.p_params(twin))
            assert all(np.array_equal(a[k], b[k]) for k in a)
            jit = pd.p_clone(src, jitter=0.05)
            diff = float(np.abs(_np(pd.p_params(jit))["w"] - a["w"]).max())
            assert 0.0 < diff < 1.0                 # perturbed, but nearby
            assert pd.particles[twin].optimizer is pd.particles[src].optimizer
            assert pd.lifecycle["clones"] == 2
        # the port's exact twin is the reference's exact twin
        assert _max_diff(_np(tpd.p_params(1)), jpd.p_params(1)) == 0.0
        # handlers travel with the clone
        tpd.particles[0].on("PING", lambda p: p.pid)
        pong = tpd.p_clone(0)
        assert tpd.p_wait([tpd.p_launch(pong, "PING")], timeout=30) == [pong]


def test_clone_copies_extra_state_keys():
    jpd, tpd = _pds(1)
    with jpd, tpd:
        jpd.particles[0].state["swag"] = {"n": jnp.ones(())}
        tpd.particles[0].state["swag"] = {"n": torch.ones(())}
        for pd in (jpd, tpd):
            twin = pd.p_clone(0)
            assert float(pd.particles[twin].state["swag"]["n"]) == 1.0
            assert pd.store.keys_for(twin) and \
                set(pd.store.keys_for(twin)) == set(pd.store.keys_for(0))


def test_clone_keeps_every_stacked_address():
    """Within capacity a clone writes into the destination slot of the
    existing stacked tensors: no tree is rebuilt, so a step captured on
    those addresses stays valid."""
    _, tpd = _pds(2)
    with tpd:
        tpd.particles[0].state["kv_pages"] = {"k": torch.zeros(5, 2)}
        for pid in (0, 1):
            tpd.particles[pid].state["kv_pages"] = {"k": torch.full(
                (5, 2), float(pid + 1))}
        keys = ("params", "opt_state", "kv_pages")
        ptrs = {k: [x.data_ptr() for x in tree_leaves(tpd.store.stacked(k))]
                for k in keys}
        gen = tpd.store.generation()
        twin = tpd.p_clone(1, jitter=0.01)
        tpd.p_kill(0)
        again = tpd.p_clone(twin)
        for k in keys:
            assert [x.data_ptr() for x in
                    tree_leaves(tpd.store.stacked(k))] == ptrs[k], k
        assert tpd.store.generation() == gen
        assert tpd.store.snapshot_stats()["slot_clones"] >= 4
        assert float(tpd.store.read("kv_pages", again)["k"][0, 0]) == 2.0


def test_clone_is_not_a_view_of_its_source():
    """The source training on (in place, as a captured step does) leaves
    the clone's rows as they were at the clone."""
    _, tpd = _pds(2)
    with tpd:
        twin = tpd.p_clone(0)
        before = {k: v.clone() for k, v in tpd.p_params(twin).items()}
        st = tpd.store.stacked("params")
        st["w"][tpd.store.slot_of(0)].add_(1.0)           # in place
        tpd.particles[0].state["params"] = {                # a dirty row
            k: v + 2.0 for k, v in tpd.p_params(0).items()}
        tpd.store.stacked("params")
        tpd.p_wait([tpd.particles[0].step(_tb(_batch()))], timeout=30)
        for k, v in tpd.p_params(twin).items():
            assert torch.equal(v, before[k]), k
        assert not torch.equal(tpd.p_params(0)["w"], before["w"])


def test_kill_then_create_reuses_slot_without_generation_bump():
    jpd, tpd = _pds(4)
    with jpd, tpd:
        got = []
        for pd in (jpd, tpd):
            store = pd.store
            gen = store.generation()
            slot = store.slot_of(1)
            pd.p_kill(1)
            assert store.live_count() == 3 and store.free_slots() == 1
            assert np.asarray(store.active_mask())[slot] == 0.0
            row = _inits(1, 9)[0]
            fresh = (jpd.p_create(jsgd(0.1),
                                  params=jax.tree.map(jnp.asarray, row))
                     if pd is jpd else
                     tpd.p_create(sgd(0.1), params=params_from_numpy(row)))
            assert store.slot_of(fresh) == slot     # freed slot reused
            assert store.generation() == gen        # no shape change
            assert store.capacity == 4
            with pytest.raises(KeyError):
                store.read("params", 1)
            with pytest.raises(KeyError):
                pd.nel.dispatch(1, lambda: None)
            assert 1 not in pd.nel._particles and 1 not in pd.nel._device_of
            with pytest.raises(KeyError):
                pd.p_kill(1)
            got.append((fresh, store.slot_of(fresh), store.pids))
        assert got[0] == got[1]


def test_kill_cleans_nel_active_set():
    jpd, tpd = _pds(2)
    with jpd, tpd:
        for pd, b in ((jpd, _jb(_batch())), (tpd, _tb(_batch()))):
            pd.p_wait([pd.particles[p].step(b) for p in (0, 1)])
            assert 0 in pd.nel._active[0]
            pd.p_kill(0)
            assert 0 not in pd.nel._active[0]
            assert pd.lifecycle["kills"] == 1


def test_capacity_growth_bumps_generation_once_per_doubling():
    inits = _inits(5)
    jmod, tmod = _modules(inits)
    seen = []
    for pd, opt in ((JPD(jmod, num_devices=1), jsgd),
                    (PushDistribution(tmod, device="cpu"), sgd)):
        with pd:
            gens, caps = [], []
            for _ in range(5):
                pd.p_create(opt(0.1))
                gens.append(pd.store.generation())
                caps.append(pd.store.capacity)
            assert caps == [1, 2, 4, 4, 8]
            assert gens[3] == gens[2] and gens[4] == gens[3] + 1
            seen.append([b > a for a, b in zip(gens, gens[1:])])
    assert seen[0] == seen[1]


def test_rebalance_on_one_device_moves_nothing():
    jpd, tpd = _pds(4, capacity=8)
    with jpd, tpd:
        for pd in (jpd, tpd):
            assert pd.p_rebalance() == {}
            assert pd.lifecycle["rebalances"] == 1
            assert pd.particle_ids() == [0, 1, 2, 3]


def test_stats_expose_lifecycle_counters():
    jpd, tpd = _pds(1)
    with jpd, tpd:
        got = []
        for pd in (jpd, tpd):
            b = pd.p_clone(0)
            pd.p_kill(b)
            pd.p_rebalance()
            lc = pd.stats()["lifecycle"]
            assert lc["mask_invalidations"] >= 3
            got.append({k: lc[k] for k in ("capacity", "live", "free_slots",
                                            "clones", "kills", "rebalances",
                                            "capacity_growths")})
        assert got[0] == got[1] == {"capacity": 4, "live": 1,
                                    "free_slots": 3, "clones": 1, "kills": 1,
                                    "rebalances": 1, "capacity_growths": 0}


# ---------------------------------------------------------------------------
# masked paths against dense subsets
# ---------------------------------------------------------------------------

def test_masked_bma_heads_match_dense_subset_and_reference():
    rng = np.random.default_rng(0)
    outs = rng.standard_normal((8, 5, 7)).astype(np.float32)
    mask = np.asarray([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    live = outs[mask > 0]
    for kind in ("classify", "regress"):
        got = predictive_heads(torch.from_numpy(outs), kind,
                               torch.from_numpy(mask))
        want = predictive_heads(torch.from_numpy(live), kind)
        ref = jpredictive_heads(jnp.asarray(outs), kind, jnp.asarray(mask))
        for k in want:
            assert float((got[k] - want[k]).abs().max()) < 1e-5, (kind, k)
            assert np.abs(got[k].numpy() - np.asarray(ref[k])).max() < 1e-5


def test_masked_heads_ignore_nan_in_dead_slots():
    outs = torch.stack([torch.ones(2, 3), torch.full((2, 3), float("nan"))])
    got = predictive_heads(outs, "regress", torch.tensor([1.0, 0.0]))
    assert bool(torch.isfinite(got["mean"]).all())


def test_masked_svgd_force_matches_dense_subset_and_reference():
    rng = np.random.default_rng(1)
    theta = rng.standard_normal((8, 6)).astype(np.float32)
    grads = rng.standard_normal((8, 6)).astype(np.float32)
    mask = np.asarray([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    keep = mask > 0
    for ell in (1.0, -1.0):            # fixed + the median heuristic
        got = svgd_force(torch.from_numpy(theta), torch.from_numpy(grads),
                         ell, mask=torch.from_numpy(mask)).numpy()
        want = svgd_force(torch.from_numpy(theta[keep]),
                          torch.from_numpy(grads[keep]), ell).numpy()
        ref = np.asarray(jsvgd_force(jnp.asarray(theta), jnp.asarray(grads),
                                     ell, mask=jnp.asarray(mask)))
        assert np.abs(got[keep] - want).max() < 1e-5, ell
        assert np.abs(got - ref).max() < 1e-5, ell
        assert np.abs(got[~keep]).max() == 0.0


def test_masked_fused_svgd_step_freezes_dead_slots():
    inits = _inits(4)
    jmod, tmod = _modules(inits)
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[jax.tree.map(jnp.asarray, t) for t in inits])
    tstacked = params_from_numpy(jax.tree.map(np.asarray, jstacked))
    w2 = tstacked["w"][2].clone()
    mask = np.asarray([1, 1, 0, 1], np.float32)
    jnew, jls = jax.jit(jfused_svgd_step(jmod.loss, lr=0.1, lengthscale=1.0))(
        jstacked, _jb(_batch()), jnp.asarray(mask))
    with torch.no_grad():
        new, ls = fused_svgd_step(tmod.loss, lr=0.1, lengthscale=1.0)(
            tstacked, _tb(_batch()), torch.from_numpy(mask))
    assert torch.equal(new["w"][2], w2)                     # frozen
    assert float(ls[2]) == 0.0
    assert not torch.equal(new["w"][0], torch.from_numpy(inits[0]["w"]))
    assert _max_diff(_np(new), jnew) < 1e-5
    assert np.abs(ls.numpy() - np.asarray(jls)).max() < 1e-5


def test_p_predict_after_churn_matches_reference():
    jpd, tpd = _pds(4, backend="compiled")
    b = _batch()
    with jpd, tpd:
        tpd.p_predict(_tb(b))                   # the program, at capacity 4
        misses = _misses(tpd)
        for pd in (jpd, tpd):
            pd.p_kill(2)
        got = tpd.p_predict(_tb(b))             # churned: the same program
        assert _misses(tpd) == misses
        ref = np.asarray(jpd.p_predict(_jb(b)))
        assert np.abs(got.numpy() - ref).max() < 1e-5
        live = np.mean([b[0] @ _np(tpd.p_params(p))["w"]
                        + _np(tpd.p_params(p))["b"] for p in (0, 1, 3)], 0)
        assert np.abs(got.numpy() - live).max() < 1e-5


# ---------------------------------------------------------------------------
# serving under churn
# ---------------------------------------------------------------------------

def test_predictive_engine_survives_churn():
    """Kill + exact clone in both packages: equal heads; a jittered clone
    in the port: heads equal to the live particles' own mean."""
    jpd, tpd = _pds(4, backend="compiled")
    x = np.random.default_rng(9).standard_normal((8, 3)).astype(np.float32)
    with jpd, tpd:
        jeng = JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                 kind="regress")
        teng = PredictiveEngine(tpd.module.forward, store=tpd.store,
                                kind="regress", cache=ProgramCache())
        teng.predict((torch.from_numpy(x), None))
        misses = teng.snapshot_stats()["program_cache"]["misses"]
        for round_ in range(3):
            for pd in (jpd, tpd):
                victim = pd.particle_ids()[0]
                pd.p_kill(victim)
                pd.p_clone(pd.particle_ids()[0],
                           jitter=0.01 if round_ == 2 and pd is tpd else 0.0)
            heads = teng.predict((torch.from_numpy(x), None))
            live = np.mean([x @ _np(tpd.p_params(p))["w"]
                            + _np(tpd.p_params(p))["b"]
                            for p in tpd.particle_ids()], 0)
            assert np.abs(heads["mean"].numpy() - live).max() < 1e-5
            if round_ < 2:
                ref = jeng.predict((jnp.asarray(x), None))
                assert np.abs(heads["mean"].numpy()
                              - np.asarray(ref["mean"])).max() < 1e-5
        assert teng.snapshot_stats()["program_cache"]["misses"] == misses
        assert tpd.stats()["lifecycle"]["clones"] == 3
        assert tpd.stats()["lifecycle"]["kills"] == 3


def test_members_returns_live_rows_only_after_churn():
    jpd, tpd = _pds(4, backend="compiled")
    x = np.random.default_rng(7).standard_normal((5, 3)).astype(np.float32)
    with jpd, tpd:
        jeng = JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                 kind="regress")
        teng = PredictiveEngine(tpd.module.forward, store=tpd.store,
                                kind="regress")
        _, outs = teng.predict((torch.from_numpy(x), None), members=True)
        assert outs.shape[0] == 4
        for pd in (jpd, tpd):
            pd.p_kill(3)
            pd.p_kill(0)
        heads, outs = teng.predict((torch.from_numpy(x), None), members=True)
        assert outs.shape == (2, 5, 4)          # live rows only, slot order
        _, jouts = jeng.predict((jnp.asarray(x), None), members=True)
        assert np.abs(outs.numpy() - np.asarray(jouts)).max() < 1e-5
        ref = np.stack([x @ _np(tpd.p_params(p))["w"]
                        + _np(tpd.p_params(p))["b"] for p in tpd.store.pids])
        assert np.abs(outs.numpy() - ref).max() < 1e-5
        assert heads["mean"].shape == (5, 4)


def _ref_plain(jcfg, rows, prompts, max_new):
    """The reference's plain scheduler over the particles ``rows`` (numpy
    trees)."""
    from repro.models import api as japi
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0) as jpd:
        for r in rows:
            jpd.p_create(params=jax.tree.map(jnp.asarray, r))
        svc = jserve_decode(jpd, jcfg, num_pages=16, page_size=8,
                            max_active=2, decode_kernel=False, warmup=False)
        try:
            return [svc.generate(p, max_new=max_new) for p in prompts]
        finally:
            svc.close()


@pytest.mark.parametrize("speculative", [False, True])
def test_decode_serving_survives_churn_with_zero_captures(speculative):
    """Paged decode (and speculative decode) under clone/kill churn made
    under ``step_lock``: no miss after warmup, no generation bump, the
    pre-churn tokens back after the round trip, equal to the reference's
    plain scheduler; speculative: killing the drafting particle re-picks
    a slot without a miss, and the one live particle's tokens equal the
    reference's plain scheduler over that particle alone."""
    jcfg, tcfg = _lm_cfgs()
    stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, 2))
    rows = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(2)]
    prompt = [3, 5, 7, 11, 13]
    want = _ref_plain(jcfg, rows, [prompt], 4)[0]
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), capacity=4,
                          device="cpu")
    pids = [pd.p_create(params=_to_port(r)) for r in rows]
    svc = serve_decode(pd, tcfg, num_pages=16, page_size=8, max_active=2,
                       warmup_buckets=(8,), speculative=speculative)
    try:
        base = svc.generate(prompt, max_new=4)
        assert base.tokens == want.tokens
        np.testing.assert_allclose(base.logprobs, want.logprobs, atol=1e-4)
        misses, gen = svc.stats()["misses"], pd.store.generation()
        with svc.scheduler.step_lock:
            twin = pd.p_clone(pids[0], jitter=0.01)
        widened = svc.generate(prompt, max_new=4)
        assert len(widened.tokens) == 4            # BMA over 3 live rows
        with svc.scheduler.step_lock:
            pd.p_kill(twin)
        back = svc.generate(prompt, max_new=4)
        assert back.tokens == base.tokens          # live set restored
        np.testing.assert_allclose(back.logprobs, base.logprobs, atol=1e-5)
        n = 3
        if speculative:
            with svc.scheduler.step_lock:
                pd.p_kill(pids[0])                 # the drafting particle
            solo = svc.generate(prompt, max_new=4)
            assert solo.tokens == _ref_plain(jcfg, rows[1:], [prompt],
                                             4)[0].tokens
            n = 4
        st = svc.stats()
        assert st["misses"] == misses, "churn captured a step"
        assert pd.store.generation() == gen
        assert st["retired"] == n
        assert st["pool"]["used_pages"] == 0
        if speculative:
            assert st["engine"]["slot_uploads"] >= 2
            assert st["speculative"]["spec_steps"] > 0
    finally:
        svc.close()
        pd.cleanup()


# ---------------------------------------------------------------------------
# fused training after churn
# ---------------------------------------------------------------------------

def test_fused_training_after_churn_reuses_program():
    inits = _inits(4)
    jmod, tmod = _modules(inits)
    data = [_batch()]
    with JDeepEnsemble(jmod, num_devices=1, backend="compiled") as jde, \
            DeepEnsemble(tmod, backend="compiled", device="cpu") as tde:
        tpd, jpd = tde.push_dist, jde.push_dist
        tpd.runtime.cache = ProgramCache()
        tde.bayes_infer(data, 2, optimizer=sgd(0.05), num_particles=4)
        jde.bayes_infer([_jb(b) for b in data], 2, optimizer=jsgd(0.05),
                        num_particles=4)
        misses = _misses(tpd)
        for pd in (jpd, tpd):
            pd.p_kill(1)
            pd.p_clone(0)
        # same capacity, same generation, same addresses: the step program
        # of a new optimizer is looked up once, and then reused
        topt, jopt = sgd(0.05), jsgd(0.05)
        tde._fused_epochs(tpd.store.pids, data, 2, optimizer=topt)
        jde._fused_epochs(jpd.store.pids, [_jb(b) for b in data], 2,
                          optimizer=jopt)
        assert _misses(tpd) == misses + 1
        assert tpd.particle_ids() != tpd.store.pids     # pid != slot order
        tde._fused_epochs(tpd.particle_ids(), data, 1, optimizer=topt)
        jde._fused_epochs(jpd.particle_ids(), [_jb(b) for b in data], 1,
                          optimizer=jopt)
        assert _misses(tpd) == misses + 1
        for pid in tpd.particle_ids():
            assert _max_diff(_np(tpd.p_params(pid)), jpd.p_params(pid)) < 1e-5


# ---------------------------------------------------------------------------
# lifecycle policies (bdl/lifecycle.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights,n,seed", [
    ([0.7, 0.1, 0.1, 0.1], 4, 0), ([0.25] * 4, 4, 3),
    ([0.0, 0.5, 0.2, 0.3, 0.0], 5, 11), ([1.0, 2.0, 3.0], 7, 5)])
def test_systematic_counts_match_reference(weights, n, seed):
    got = lifecycle.systematic_counts(weights, n, np.random.default_rng(seed))
    assert got == jlifecycle.systematic_counts(weights, n,
                                               np.random.default_rng(seed))
    assert sum(got) == n
    with pytest.raises(ValueError):
        lifecycle.systematic_counts([0.0, 0.0], 2)


def test_ensemble_weights_match_reference():
    jpd, tpd = _pds(4)
    with jpd, tpd:
        got = lifecycle.ensemble_weights(tpd, _batch())
        want = jlifecycle.ensemble_weights(jpd, _jb(_batch()))
        assert list(got) == list(want)
        assert max(abs(got[p] - want[p]) for p in got) < 1e-5
        assert abs(sum(got.values()) - 1.0) < 1e-9


def test_resample_matches_reference_and_preserves_capacity():
    jpd, tpd = _pds(4, backend="compiled")
    b = _batch()
    with jpd, tpd:
        tpd.p_predict(_tb(b))
        cap, gen, misses = tpd.store.capacity, tpd.store.generation(), \
            _misses(tpd)
        weights = lifecycle.ensemble_weights(tpd, b)
        live = lifecycle.resample(tpd, weights, jitter=0.01,
                                  rng=np.random.default_rng(1))
        jlive = jlifecycle.resample(jpd, weights, jitter=0.01,
                                    rng=np.random.default_rng(1))
        assert live == jlive and len(live) == 4
        assert tpd.store.pids == jpd.store.pids
        assert tpd.store.capacity == cap and tpd.store.generation() == gen
        tpd.p_predict(_tb(b))
        assert _misses(tpd) == misses
        lc = tpd.stats()["lifecycle"]
        assert lc["kills"] == lc["clones"] == jpd.lifecycle["kills"]
        with pytest.raises(ValueError):
            lifecycle.resample(tpd)


def test_grow_warm_starts_from_best_member():
    inits = _inits(2)
    jmod, tmod = _modules(inits)
    data = [_batch()]
    with DeepEnsemble(tmod, backend="compiled", capacity=4,
                      device="cpu") as de:
        pd = de.push_dist
        pd.runtime.cache = ProgramCache()
        de.bayes_infer(data, 2, optimizer=sgd(0.05), num_particles=2)
        w = lifecycle.ensemble_weights(de, data[0])
        best = max(w, key=w.get)
        gen = pd.store.generation()
        opt = sgd(0.05)
        new = lifecycle.grow(de, 2, jitter=0.02, weights=w, optimizer=opt)
        assert len(pd.particle_ids()) == 4 and pd.store.generation() == gen
        for pid in new:
            d = float((pd.p_params(pid)["w"] - pd.p_params(best)["w"])
                      .abs().max())
            assert 0.0 < d < 0.5        # warm start near the best member
            assert pd.particles[pid].optimizer is opt
        de._fused_epochs(pd.store.pids, data, 2, optimizer=opt)
        assert all(bool(torch.isfinite(pd.p_params(p)["w"]).all())
                   for p in pd.particle_ids())
        assert lifecycle.grow(de, 1, jitter=0.0) == [4]     # the first live
        assert pd.store.capacity == 8                        # one doubling


def test_prune_keeps_heaviest_members():
    jpd, tpd = _pds(4)
    with jpd, tpd:
        weights = {p: float(i) for i, p in enumerate(range(4))}
        live = lifecycle.prune(tpd, 2, weights=weights)
        assert live == jlifecycle.prune(jpd, 2, weights=weights) == [2, 3]
        with pytest.raises(ValueError):
            lifecycle.prune(tpd, 0, weights=weights)


# ---------------------------------------------------------------------------
# the store's churn windows
# ---------------------------------------------------------------------------

def test_slot_activates_only_after_data_lands():
    for store, row in ((JParticleStore(capacity=4), jnp.ones),
                       (ParticleStore(capacity=4, device="cpu"),
                        torch.ones)):
        store.register(0)
        assert np.asarray(store.active_mask()).sum() == 0   # no data yet
        store.write("params", 0, {"w": row((2,))})
        assert np.allclose(np.asarray(store.active_mask()), [1, 0, 0, 0])
        store.register(1)
        assert np.allclose(np.asarray(store.active_mask()), [1, 0, 0, 0])
        store.write("params", 1, {"w": row((2,)) * 0})
        assert np.allclose(np.asarray(store.active_mask()), [1, 1, 0, 0])
        assert store.live_slots() == [0, 1]


def test_mid_run_register_survives_full_commit():
    store = ParticleStore(capacity=4, device="cpu")
    for pid in range(2):
        store.register(pid)
        store.write("params", pid, {"w": torch.full((2,), float(pid))})
    co = store.checkout("params")
    assert co["w"].shape[0] == 4
    store.register(5)                                       # mid-run create
    store.write("params", 5, {"w": torch.full((2,), 9.0)})
    store.commit("params", tree_map(lambda x: x + 1.0, co))
    assert float(store.read("params", 0)["w"][0]) == 1.0
    assert float(store.read("params", 1)["w"][0]) == 2.0
    assert float(store.read("params", 5)["w"][0]) == 9.0
    assert float(store.stacked("params")["w"][store.slot_of(5), 0]) == 9.0
    assert np.asarray(store.active_mask()).sum() == 3


def test_clone_during_checkout_fails_loudly():
    for store, row in ((JParticleStore(capacity=4), jnp.ones),
                       (ParticleStore(capacity=4, device="cpu"),
                        torch.ones)):
        store.register(0)
        store.write("params", 0, {"w": row((2,))})
        store.register(1)
        co = store.checkout("params")
        with pytest.raises(RuntimeError, match="checked out"):
            store.clone_slot("params", 0, 1)
        store.commit("params", co)
        store.clone_slot("params", 0, 1)            # fine after commit
        assert float(store.read("params", 1)["w"][0]) == 1.0
        with pytest.raises(KeyError):
            store.clone_slot("opt_state", 0, 1)     # the source has none


def test_failed_clone_leaves_no_particle():
    _, tpd = _pds(2)
    with tpd:
        co = tpd.store.checkout("opt_state")
        with pytest.raises(RuntimeError, match="checked out"):
            tpd.p_clone(0)
        tpd.store.commit("opt_state", co)
        assert tpd.particle_ids() == [0, 1] and len(tpd.store) == 2
        assert tpd.store.free_slots() == 2
        assert tpd.p_clone(0) == 3                  # pid 2 was the failure


def test_capacity_growth_during_checkout_does_not_lose_the_run():
    store = ParticleStore(device="cpu")             # grows on demand
    for pid in range(2):
        store.register(pid)
        store.write("params", pid, {"w": torch.full((2,), float(pid))})
    co = store.checkout("params")                   # capacity 2
    store.register(2)                               # grow: capacity 2 -> 4
    store.write("params", 2, {"w": torch.full((2,), 7.0)})
    store.commit("params", tree_map(lambda x: x + 1.0, co))
    assert store.capacity == 4
    assert float(store.read("params", 0)["w"][0]) == 1.0
    assert float(store.read("params", 2)["w"][0]) == 7.0
    assert store.stacked("params")["w"].shape[0] == 4
