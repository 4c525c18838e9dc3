"""The port's SciML workload against the JAX package, on the CPU: the
advection data, the 1-D UNet (``models/unet1d.py``, the "pde" branches of
``models/api.py``), its training by DeepEnsemble, SteinVGD and MultiSWAG,
fused and on the NEL, and its posterior served as a regression BMA.

Both packages run the same weights (the reference initializes them and
they cross over as numpy, ``interop.params_from_numpy``) at small sizes:
the smoke config (d_model 32, n_units 2) and narrower ones (d_model 8-16,
n_units 2-3), on grids of L = 16 and L = 20 (20 -> 10 -> 5 -> 3: the
upsample's slice to the skip's length matters there). Tolerances:

  * forward and loss 1e-5 relative to the largest |value|;
  * grads 1e-5 relative to the largest |grad|: the two packages sum each
    conv's 3 * cin products (up to 1,536 at full width) in another order,
    and the backward chains every stage's sums, so the grads carry a few
    fp32 roundings of each product more than the forward (measured: under
    1.3e-6 at the full width on the CPU, a margin of ~8);
  * the fused steps against the reference's fused steps: DeepEnsemble
    params 1e-5, SteinVGD params 2e-4 relative (the force's bar), SWAG
    moments 1e-5, losses 1e-5;
  * the NEL against the compiled path within 1e-4 (DESIGN.md §3);
  * the regression heads 1e-5.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro import configs as jconfigs
from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import SteinVGD as JSteinVGD
from repro.bdl.swag import swag_sample_stacked as jswag_sample_stacked
from repro.core import ParticleModule as JModule
from repro.data import DataLoader as JDataLoader
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.core import ParticleModule
from repro_torch.core.functional import (ensemble_value_and_grad,
                                         flatten_rows, flatten_stacked)
from repro_torch.core.tree import tree_flatten
from repro_torch.data import DataLoader, advection_batch, make_batch
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.optim import sgd
from repro_torch.serve import PredictiveEngine, serve
from test_torch_nel import _bounded
from test_torch_swag_serve import _paths, _reference_noise

TINY = dict(d_model=8, n_units=2, max_seq_len=16)
N, CAP, EPOCHS, LR = 4, 6, 2, 0.05


def _cfgs(**kw):
    kw = TINY if not kw else kw
    return (jconfigs.get("unet-advection").smoke().replace(**kw),
            tconfigs.get("unet-advection").smoke().replace(**kw))


def _numpy_inits(jcfg, n, seed=0):
    """The particles the reference's PushDistribution(seed) creates, in
    creation order, as numpy trees."""
    init = jax.jit(lambda k: japi.init_params(k, jcfg))   # one compile
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(jax.tree.map(np.asarray, init(sub)))
    return out


def _modules(jcfg, tcfg, inits):
    """A JAX and a port module whose inits hand out the same particles."""
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: japi.loss_fn(p, b, jcfg),
                   lambda p, b: japi.forward(p, b, jcfg)[0], cfg=jcfg)
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)),
                          lambda p, b: tapi.loss_fn(p, b, tcfg),
                          lambda p, b: tapi.forward(p, b, tcfg)[0], cfg=tcfg)
    return jmod, tmod


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# data and config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,L", [(0, 16), (3, 20), (7, 128)])
def test_advection_batches_byte_identical(seed, L):
    want = jsynthetic.advection_batch(np.random.default_rng(seed), 5, L)
    got = advection_batch(np.random.default_rng(seed), 5, L)
    jcfg, tcfg = _cfgs(d_model=8, n_units=2, max_seq_len=L)
    for w, g in ((want, got),
                 (jsynthetic.make_batch(jcfg, np.random.default_rng(seed), 5,
                                        0),
                  make_batch(tcfg, np.random.default_rng(seed), 5, 0))):
        assert set(g) == set(w) == {"u0", "u1"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == (5, L, 1)
            assert g[k].tobytes() == w[k].tobytes()
    # the loader: two epochs, the seed advancing per epoch
    jl = JDataLoader(jcfg, batch_size=3, num_batches=2, seed=seed)
    tl = DataLoader(tcfg, batch_size=3, num_batches=2, seed=seed)
    for _ in range(2):
        for jb, tb in zip(jl, tl):
            assert all(jb[k].tobytes() == tb[k].tobytes() for k in jb)


@pytest.mark.parametrize("seed", range(0, 31, 6))
def test_advection_exact_shift(seed):
    """The port's copy of ``tests/test_property.py``'s exact shift."""
    b = advection_batch(np.random.default_rng(seed), 2, L=64, c=1.0, dt=4.0)
    assert np.allclose(np.roll(b["u0"], 4, axis=1), b["u1"])


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_fields_and_footprint_match_jax(variant):
    j, t = jconfigs.get("unet-advection"), tconfigs.get("unet-advection")
    if variant == "smoke":
        j, t = j.smoke(), t.smoke()
        assert (t.d_model, t.n_units) == (32, 2)
    for f in ("name", "family", "d_model", "vocab_size", "pattern",
              "n_units", "act", "max_seq_len", "default_particles"):
        assert getattr(t, f) == getattr(j, f), f
    assert tapi.param_footprint(t) == japi.param_footprint(j)
    assert tapi.param_footprint(t, "bf16") == japi.param_footprint(j, "bf16")


def test_unet_init_paths_shapes_and_scale():
    """The carried-over tree keeps the reference's key paths, tuples and
    ``(k, cin, cout)`` layout; the port's own init builds the same paths
    and shapes, ``w`` at std 1/sqrt(k cin) and ``b`` zeros; the full
    config has 1,240,065 parameters in 34 leaves."""
    jcfg, tcfg = _cfgs(d_model=16, n_units=3, max_seq_len=20)
    jtree = japi.init_params(jax.random.PRNGKey(0), jcfg)
    carried = params_from_numpy(jax.tree.map(np.asarray, jtree))
    assert isinstance(carried["enc"], tuple) and isinstance(carried["dec"],
                                                            tuple)
    want = {p: np.asarray(x) for p, x in _paths(jax.tree.map(np.asarray,
                                                               jtree))}
    got = dict(_paths(carried))
    assert set(got) == set(want)
    for p in want:
        assert tuple(got[p].shape) == want[p].shape
        assert np.array_equal(got[p].numpy(), want[p])
    assert tuple(got[("dec", 0, "c1", "w")].shape) == (3, 64 + 64, 64)
    full = tapi.init_params(torch.Generator().manual_seed(0),
                            tconfigs.get("unet-advection"))
    own = dict(_paths(full))
    jfull = jax.eval_shape(lambda k: japi.init_params(
        k, jconfigs.get("unet-advection")), jax.random.PRNGKey(0))
    assert {p: tuple(x.shape) for p, x in own.items()} == \
        {p: tuple(x.shape) for p, x in _paths(jfull)}
    assert len(own) == 34
    assert sum(x.numel() for x in own.values()) == 1_240_065
    for p, x in own.items():
        if p[-1] == "b":
            assert torch.count_nonzero(x) == 0
        elif x.numel() >= 3000:
            k, cin, _ = x.shape
            assert abs(float(x.std()) * np.sqrt(k * cin) - 1.0) < 0.05, p


@pytest.mark.parametrize("kw", [dict(d_model=8, n_units=2, max_seq_len=16),
                                dict(d_model=16, n_units=3, max_seq_len=20),
                                dict(d_model=32, n_units=2, max_seq_len=16)],
                         ids=["d8-u2-L16", "d16-u3-L20", "smoke-L16"])
def test_unet_forward_loss_and_grads_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    P = 3
    stacked = jax.jit(jax.vmap(lambda k: japi.init_params(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(1), P))
    tparams = params_from_numpy(jax.tree.map(np.asarray, stacked))
    batch = next(iter(JDataLoader(jcfg, batch_size=5, num_batches=1)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    want = jax.jit(jax.vmap(lambda p: japi.forward(p, batch, jcfg)[0]))(
        stacked)
    got = tapi.forward(tparams, tbatch, tcfg)[0]
    assert tuple(got.shape) == (P, 5, kw["max_seq_len"], 1)
    assert _rel(got.numpy(), want) < 1e-5

    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg)[0])))(stacked)
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(tparams, tbatch)
    assert tuple(tloss.shape) == (P,)
    assert _rel(tloss.numpy(), jloss) < 1e-5
    metrics = tapi.loss_fn(tparams, tbatch, tcfg)[1]
    assert set(metrics) == {"loss"}
    jflat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(jgrads))
    tflat = flatten_stacked(tgrads)[0].numpy()
    assert tflat.shape == jflat.shape
    assert _rel(tflat, jflat) < 1e-5


# ---------------------------------------------------------------------------
# the BDL algorithms on the UNet, fused and on the NEL
# ---------------------------------------------------------------------------

ALGOS = {
    "ensemble": (DeepEnsemble, JDeepEnsemble,
                 lambda opt: {"optimizer": opt(LR)}),
    "multiswag": (MultiSWAG, JMultiSWAG,
                  lambda opt: {"optimizer": opt(LR), "max_rank": 3,
                               "pretrain_epochs": 0}),
    "svgd-median": (SteinVGD, JSteinVGD,
                    lambda opt: {"lr": LR, "lengthscale": 0.0}),
    "svgd-ell1": (SteinVGD, JSteinVGD,
                  lambda opt: {"lr": LR, "lengthscale": 1.0}),
}


def _loaders(jcfg, tcfg):
    return (JDataLoader(jcfg, batch_size=4, num_batches=2, seed=0),
            DataLoader(tcfg, batch_size=4, num_batches=2, seed=0))


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_fused_training_matches_jax(name):
    """The fused steps in a store of capacity 6 holding 4 particles (the
    mask is live) against the reference's fused steps on shared inits."""
    jcfg, tcfg = _cfgs()
    jmod, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    cls, jcls, kw = ALGOS[name]
    jl, tl = _loaders(jcfg, tcfg)
    jalgo = jcls(jmod, backend="compiled", capacity=CAP)
    talgo = cls(tmod, backend="compiled", capacity=CAP, device="cpu")
    _, jloss = jalgo.bayes_infer(jl, EPOCHS, num_particles=N, **kw(jsgd))
    _, tloss = talgo.bayes_infer(tl, EPOCHS, num_particles=N, **kw(sgd))
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-5
    assert np.array(tloss).min() > 0
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        want = np.asarray(ravel_pytree(jp)[0])
        got = flatten_rows([tp])[0][0].numpy()
        if name.startswith("svgd"):
            assert _rel(got, want) < 2e-4
        else:
            assert np.abs(got - want).max() < 1e-5
    if name == "multiswag":
        jswag, tswag = jalgo.store.dense("swag"), talgo.store.dense("swag")
        for key in ("mean", "sq_mean", "dev"):
            want = dict(_paths(jax.tree.map(np.asarray, jswag[key])))
            for p, x in _paths(tswag[key]):
                assert np.abs(x.numpy() - want[p]).max() < 1e-5, (key, p)
        assert np.array_equal(tswag["rank"].numpy(), np.full(N, EPOCHS))
    for _, leaf in _paths(talgo.store.stacked("params")):
        assert torch.count_nonzero(leaf[N:]) == 0     # dead slots frozen
    batch = next(iter(JDataLoader(jcfg, batch_size=3, num_batches=1,
                                  seed=9)))
    assert _rel(talgo.posterior_pred(batch).numpy(),
                jalgo.posterior_pred(batch)) < 1e-4


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_nel_matches_compiled(name):
    """``backend="nel"`` (SteinVGD: the leader protocol) against the
    port's compiled path from the same inits: params, losses, SWAG
    moments and ``posterior_pred`` within 1e-4."""
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(jcfg, N)
    cls, _, kw = ALGOS[name]
    runs = {}
    for backend in ("nel", "compiled"):
        _, tmod = _modules(jcfg, tcfg, inits)
        algo = cls(tmod, backend=backend, device="cpu")
        pids, losses = _bounded(algo.bayes_infer, _loaders(jcfg, tcfg)[1],
                                EPOCHS, num_particles=N, **kw(sgd))
        runs[backend] = (algo, pids, losses)
    (nel, npids, nloss), (comp, cpids, closs) = runs["nel"], \
        runs["compiled"]
    try:
        assert np.abs(np.array(nloss) - np.array(closs)).max() < 1e-4
        for a, b in zip(nel.p_parameters(), comp.p_parameters()):
            assert (flatten_rows([a])[0] - flatten_rows([b])[0]
                    ).abs().max().item() < 1e-4
        if name == "multiswag":
            for pa, pb in zip(npids, cpids):
                sa = nel.push_dist.particles[pa].state["swag"]
                sb = comp.push_dist.particles[pb].state["swag"]
                assert int(sa["rank"]) == int(sb["rank"]) == EPOCHS
                for key in ("mean", "sq_mean"):
                    for x, y in zip(tree_flatten(sa[key], sort_keys=True)[0],
                                    tree_flatten(sb[key], sort_keys=True)[0]):
                        assert (x - y).abs().max().item() < 1e-4
        batch = next(iter(DataLoader(tcfg, batch_size=3, num_batches=1,
                                     seed=9)))
        got = _bounded(nel.posterior_pred, batch)
        want = comp.posterior_pred(batch)
        assert tuple(got.shape) == (3, tcfg.max_seq_len, 1)
        assert (got - want).abs().max().item() < 1e-4
    finally:
        nel.cleanup()
        comp.cleanup()


# ---------------------------------------------------------------------------
# the posterior served as a regression BMA
# ---------------------------------------------------------------------------

HEADS = ("mean", "variance", "entropy", "mutual_info", "expected_entropy")


def _close_heads(got, want, tol):
    for k in HEADS:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max()), k


def test_regress_heads_match_jax():
    """``PredictiveEngine(kind="regress")`` on a static stacked tree
    against the reference engine: the mixture's mean and variance per
    (L, 1) output, the Gaussian entropy and the mutual information per
    example."""
    jcfg, tcfg = _cfgs(d_model=16, n_units=3, max_seq_len=20)
    stacked = jax.jit(jax.vmap(lambda k: japi.init_params(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(2), 4))
    batch = next(iter(JDataLoader(jcfg, batch_size=3, num_batches=1,
                                  seed=2)))
    want = JPredictiveEngine(lambda p, b: japi.forward(p, b, jcfg)[0],
                             params=stacked, kind="regress").predict(batch)
    got = PredictiveEngine(lambda p, b: tapi.forward(p, b, tcfg)[0],
                           params=params_from_numpy(
                               jax.tree.map(np.asarray, stacked)),
                           kind="regress").predict(batch)
    _close_heads(got, want, 1e-5)
    assert tuple(got["mean"].shape) == tuple(got["variance"].shape) \
        == (3, 20, 1)
    assert tuple(got["entropy"].shape) == tuple(got["mutual_info"].shape) \
        == (3,)


def test_serve_regress_single_example_requests():
    """``serve(pd, kind="regress")`` over a trained DeepEnsemble: single
    ``u0 (L, 1)`` requests from two threads, coalesced by the batcher and
    split back along the batch axis of ``(B, L, 1)`` outputs, equal to
    ``predict_batch``'s rows and to the reference's regression heads on
    the same params; nothing is captured after the warmup."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    algo = DeepEnsemble(tmod, backend="compiled", device="cpu")
    algo.bayes_infer(_loaders(jcfg, tcfg)[1], 1, optimizer=sgd(LR),
                     num_particles=N)
    data = advection_batch(np.random.default_rng(4), 10,
                           tcfg.max_seq_len)["u0"]
    reqs = [{"u0": u} for u in data]
    with serve(algo, kind="regress", max_batch=4, max_wait_ms=2.0,
               warmup=reqs[0]) as svc:
        cold = svc.stats()["engine"]["program_cache"]["cold_compiles"]
        out = [None] * len(reqs)

        def client(c):
            hs = [(i, svc.predict_async(reqs[i]))
                  for i in range(c, len(reqs), 2)]
            for i, h in hs:
                out[i] = h.result(60.0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        st = svc.stats()
        assert st["engine"]["program_cache"]["cold_compiles"] == cold
        assert st["requests"] == len(reqs) and st["errors"] == 0
        heads = svc.predict_batch({"u0": data})
    for i, p in enumerate(out):
        assert p.mean.shape == p.variance.shape == (tcfg.max_seq_len, 1)
        assert np.shape(p.entropy) == np.shape(p.mutual_info) == ()
        for k in HEADS:
            assert np.abs(getattr(p, k) - heads[k][i].numpy()).max() \
                <= 1e-5, k
    stacked = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda x: x.numpy(), algo.store.dense("params")))
    want = JPredictiveEngine(lambda p, b: japi.forward(p, b, jcfg)[0],
                             params=stacked, kind="regress").predict(
        {"u0": data})
    _close_heads(heads, want, 1e-5)
    # the mean is the members' mean computed on the host
    members = tapi.forward(algo.store.dense("params"),
                           {"u0": torch.from_numpy(data)}, tcfg)[0]
    assert (heads["mean"] - members.mean(0)).abs().max().item() <= 1e-5


def test_multiswag_regress_posterior_predictive_matches_jax():
    """``MultiSWAG.posterior_predictive(kind="regress",
    samples_per_particle=2)`` (the diagonal scale through #4's dispatch)
    on the reference's noise against the reference's regression heads
    over its own draws."""
    jcfg, tcfg = _cfgs()
    jmod, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    jl, tl = _loaders(jcfg, tcfg)
    kw = dict(num_particles=N, pretrain_epochs=0, max_rank=3)
    jalgo = JMultiSWAG(jmod, backend="compiled")
    talgo = MultiSWAG(tmod, backend="compiled", device="cpu")
    jalgo.bayes_infer(jl, EPOCHS, optimizer=jsgd(LR), **kw)
    talgo.bayes_infer(tl, EPOCHS, optimizer=sgd(LR), **kw)
    # the reference's trained state on both sides (the packages' moments
    # differ by ~1e-7, which the diagonal scale may amplify where a leaf
    # barely moved)
    talgo.store.commit("swag", params_from_numpy(
        jax.tree.map(np.array, jalgo.store.stacked("swag"))))
    batch = next(iter(JDataLoader(jcfg, batch_size=3, num_batches=1,
                                  seed=1)))
    rng = jax.random.PRNGKey(0)
    # the reference's posterior_predictive in two parts, its sampling
    # jitted (eager, op by op, it takes ~25 s over the 18 leaves here)
    sampled = jax.jit(lambda st, r: jswag_sample_stacked(st, r, 2))(
        jalgo.store.dense("swag"), rng)
    want = jalgo.push_dist.serve(params=sampled,
                                 kind="regress").predict_batch(batch)
    z1, z2 = _reference_noise(jalgo.store.dense("swag"), rng, 2)
    with talgo.posterior_predictive(
            samples_per_particle=2, kind="regress",
            noise=(params_from_numpy(z1), torch.from_numpy(z2))) as svc:
        got = svc.predict_batch(batch)
    _close_heads(got, want, 1e-5)
    assert float(got["variance"].mean()) > 0
