"""The port's training slice against the JAX package, on the CPU.

Both packages run the same weights: the reference initializes them and
they cross over as numpy through ``repro_torch.interop.params_from_numpy``;
batches come from each package's own copy of the seeded data loader.
Checks, on the ViT-MNIST config at a tiny width (2 layers, d_model 64,
4 heads, d_ff 128):

  * configs, parameter key paths and shapes, and data loader batches;
  * the ViT forward logits, loss and per-particle gradients, 1e-4;
  * one ``adam`` and one ``sgd`` update on shared grads with a per-row
    step, 1e-6; three ``adafactor`` updates of a stacked 1-D, 2-D and
    unit-stacked 3-D leaf against ``jax.vmap`` of the reference's, 1e-6,
    with and without the clip firing; the three schedules at steps 0, 1,
    warmup, total and past it, 0-d and per row, 1e-6 relative; the
    reference's quadratic for each optimizer on the port;
  * fused DeepEnsemble and SteinVGD (median heuristic and fixed ell), 2
    epochs x 2 batches with ``sgd``, 6 particles in a store of capacity 8
    so the mask is live: params and losses within 1e-4, then
    ``p_predict`` within 1e-4;
  * the actor backend (``backend="nel"``) is the default: it trains and
    predicts (``tests/test_torch_nel.py`` holds it to the compiled path
    and to the reference's NEL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro import configs as jconfigs
from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import SteinVGD as JSteinVGD
from repro.core import ParticleModule as JModule
from repro.data import DataLoader as JDataLoader
from repro.models import api as japi
from repro.optim import adafactor as jadafactor
from repro.optim import adam as jadam
from repro.optim import schedules as jschedules
from repro.optim import sgd as jsgd
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, SteinVGD
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import (ensemble_value_and_grad,
                                         flatten_stacked)
from repro_torch.core.tree import tree_map
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch import optim as toptim
from repro_torch.optim import adafactor, adam, sgd

TINY = dict(n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128)
N, CAP, EPOCHS, LR = 6, 8, 2, 0.05


def _cfgs():
    return (jconfigs.get("vit-mnist").smoke().replace(**TINY),
            tconfigs.get("vit-mnist").smoke().replace(**TINY))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def _numpy_inits(jcfg, n):
    """The particles the reference's PushDistribution(seed=0) creates, in
    creation order, as numpy trees."""
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(jax.tree.map(np.asarray, japi.init_params(sub, jcfg)))
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


def _flat_jax(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _flat_torch(tree):
    return flatten_stacked(tree_map(lambda x: x[None], tree))[0][0].numpy()


@pytest.mark.parametrize("variant", ["full", "smoke", "tiny"])
def test_vit_config_fields_match_jax(variant):
    j, t = jconfigs.get("vit-mnist"), tconfigs.get("vit-mnist")
    if variant == "smoke":
        j, t = j.smoke(), t.smoke()
    elif variant == "tiny":
        j, t = _cfgs()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.hd, t.n_layers) == (j.hd, j.n_layers)


def test_vit_params_key_paths_and_shapes():
    """The carried-over tree keeps the reference's key paths; the port's
    own init builds the same paths and shapes; the full config has the
    reference's parameter count."""
    jcfg, tcfg = _cfgs()
    want = jax.tree_util.tree_flatten_with_path(
        japi.init_params(jax.random.PRNGKey(0), jcfg))[0]
    want = {tuple(k.key for k in path): leaf for path, leaf in want}
    got = dict(_paths(params_from_numpy(
        jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0),
                                                  jcfg)))))
    assert set(got) == set(want)
    own = dict(_paths(tapi.init_params(torch.Generator().manual_seed(0),
                                       tcfg)))
    assert {p: tuple(t.shape) for p, t in own.items()} == \
        {p: tuple(np.shape(x)) for p, x in want.items()}
    full = jax.eval_shape(lambda k: japi.init_params(
        k, jconfigs.get("vit-mnist")), jax.random.PRNGKey(0))
    n_full = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    full_own = tapi.init_params(torch.Generator().manual_seed(0),
                                tconfigs.get("vit-mnist"))
    assert sum(x.numel() for _, x in _paths(full_own)) == n_full \
        == 19_775_360


def test_params_from_numpy_keeps_0d_arrays():
    """Counts and steps are 0-d per particle (SWAG ``n``/``rank``, the
    optimizer ``step``): they must not come across as shape (1,)."""
    tree = {"n": np.float32(2.0), "rank": np.array(3, np.int32),
            "w": np.ones((2, 3), np.float32)}
    got = params_from_numpy(tree)
    assert got["n"].shape == () and got["rank"].shape == ()
    assert got["rank"].dtype == torch.int32 and got["w"].shape == (2, 3)


def test_data_loader_batches_identical():
    jcfg, tcfg = _cfgs()
    jl = JDataLoader(jcfg, batch_size=7, num_batches=3, seed=4)
    tl = DataLoader(tcfg, batch_size=7, num_batches=3, seed=4)
    for _ in range(2):                      # two epochs: the seed advances
        for jb, tb in zip(jl, tl):
            assert set(jb) == set(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                assert np.array_equal(jb[k], tb[k])


def test_vit_forward_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    P = 3
    stacked = jax.vmap(lambda k: japi.init_params(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(1), P))
    tparams = params_from_numpy(jax.tree.map(np.asarray, stacked))
    batch = next(iter(JDataLoader(jcfg, batch_size=5, num_batches=1)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    jlogits = jax.jit(jax.vmap(
        lambda p: japi.forward(p, batch, jcfg)[0]))(stacked)
    tlogits = tapi.forward(tparams, tbatch, tcfg)[0]
    assert np.abs(tlogits.numpy() - np.asarray(jlogits)).max() < 1e-4

    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg)[0])))(stacked)
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(tparams, tbatch)
    assert np.abs(tloss.numpy() - np.asarray(jloss)).max() < 1e-4
    jflat = np.asarray(jax.vmap(lambda t: ravel_pytree(t)[0])(jgrads))
    tflat, unravel = flatten_stacked(tgrads)
    assert tflat.shape == jflat.shape
    assert np.abs(tflat.numpy() - jflat).max() < 1e-4
    # unravel is the exact inverse of the flatten
    for a, b in zip(_paths(unravel(tflat)), _paths(tgrads)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_update_matches_jax(name):
    """One update of stacked state on shared grads, with a different step
    on every row (what jax.vmap(optimizer.update) sees)."""
    jopt, topt = {"adam": (jadam(1e-3), adam(1e-3)),
                  "sgd": (jsgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9))
                  }[name]
    rng = np.random.default_rng(3)
    P = 3
    params = {"a": rng.standard_normal((P, 4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((P, 7)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    state = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    state = jax.tree.map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(
            np.float32) ** 2 if x.dtype == np.float32 else np.asarray(x),
        state)
    state["step"] = np.array([0, 3, 7], np.int32)
    jp, js = jax.vmap(jopt.update)(params, grads, state)
    tp, ts = topt.update(params_from_numpy(params), params_from_numpy(grads),
                         params_from_numpy(state))
    for want, got in ((jp, tp), (js, ts)):
        want = dict(_paths(jax.tree.map(np.asarray, want)))
        got = dict(_paths(got))
        assert set(got) == set(want)
        for path in want:
            assert np.abs(got[path].numpy() - want[path]).max() < 1e-6, path
    own = topt.init(params_from_numpy(jax.tree.map(lambda x: x[0], params)))
    assert own["step"].dtype == torch.int32 and own["step"].dim() == 0


SCHEDULES = {"constant": ((0.3,), (4, 9, 14)),
             "cosine": ((0.3, 10), (4, 10, 14)),
             "warmup_cosine": ((3e-3, 4, 12), (4, 12, 17))}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("rows", [False, True], ids=["0d", "per-row"])
def test_schedules_match_jax(name, rows):
    """Each schedule at steps 0, 1, warmup (or mid), total and past total,
    as a 0-d step and as one (P,) step of all five, against the
    reference's on the same int32 steps."""
    args, _ = SCHEDULES[name]
    steps = np.array([0, 1] + list(SCHEDULES[name][1]), np.int32)
    jf, tf = getattr(jschedules, name)(*args), getattr(toptim, name)(*args)
    want = np.array([float(jf(jnp.int32(s))) for s in steps])
    if rows:
        got = np.broadcast_to(np.asarray(tf(torch.from_numpy(steps))),
                              steps.shape)
    else:
        got = np.array([float(tf(torch.tensor(s))) for s in steps])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _adafactor_case(seed=4, P=3):
    rng = np.random.default_rng(seed)
    params = {"b": rng.standard_normal((P, 7)).astype(np.float32),
              "w": rng.standard_normal((P, 4, 6)).astype(np.float32),
              "units": {"w": rng.standard_normal((P, 2, 5, 3)).astype(
                  np.float32)}}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3.0
                                     ).astype(np.float32), params)
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clip", [1.0, 0.05, 1e9],
                         ids=["clip1", "clip-fires", "no-clip"])
def test_adafactor_update_matches_jax(clip):
    """Three stacked updates on shared grads against ``jax.vmap`` of the
    reference's per-particle update (what its fused step runs), per-row
    steps starting at 0, 2 and 5: a 1-D leaf (unfactored), a 2-D one and
    a unit-stacked (n_units, d_in, d_out) one (factored over the last two
    axes, one RMS across its units). The schedule is warmup_cosine."""
    params, grads = _adafactor_case()
    jopt = jadafactor(jschedules.warmup_cosine(0.1, 2, 8),
                      clip_threshold=clip)
    topt = adafactor(toptim.warmup_cosine(0.1, 2, 8), clip_threshold=clip)
    js = jax.vmap(jopt.init)(jax.tree.map(jnp.asarray, params))
    js["step"] = jnp.array([0, 2, 5], jnp.int32)
    ts = params_from_numpy(jax.tree.map(np.asarray, js))
    jp, tp = params, params_from_numpy(params)
    upd = jax.jit(jax.vmap(jopt.update))
    for g in grads:
        jp, js = upd(jp, g, js)
        tp, ts = topt.update(tp, params_from_numpy(g), ts)
    for want, got in ((jp, tp), (js, ts)):
        want = dict(_paths(jax.tree.map(np.asarray, want)))
        got = dict(_paths(got))
        assert set(got) == set(want)
        for path in want:
            assert str(got[path].dtype) == f"torch.{want[path].dtype}"
            assert np.abs(got[path].numpy() - want[path]).max() \
                <= 1e-6 * max(1.0, np.abs(want[path]).max()), path
    assert ts["v"]["w"]["vr"].shape == (3, 4)
    assert ts["v"]["units"]["w"]["vc"].shape == (3, 2, 3)
    if clip == 0.05:     # the clip fired: the update differs from no clip
        free = adafactor(toptim.warmup_cosine(0.1, 2, 8), clip_threshold=1e9)
        fs = params_from_numpy(jax.tree.map(np.asarray, jax.vmap(
            jopt.init)(jax.tree.map(jnp.asarray, params))))
        fp, _ = free.update(params_from_numpy(params),
                            params_from_numpy(grads[0]), fs)
        cp, _ = topt.update(params_from_numpy(params),
                            params_from_numpy(grads[0]), fs)
        assert not torch.allclose(fp["w"], cp["w"])


@pytest.mark.parametrize("name", ["sgd", "adam", "adafactor"])
def test_optimizers_minimize_quadratic(name):
    """``tests/test_substrate.py``'s quadratic on the port: one particle,
    a 0-d step, 100 updates."""
    opt = {"sgd": sgd(0.1, momentum=0.9), "adam": adam(0.05),
           "adafactor": toptim.make_optimizer("adafactor", 0.1)}[name]
    assert opt.name == name
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((2, 2))}

    def loss(p):
        return (p["w"] ** 2).sum() + ((p["m"] - 1.0) ** 2).sum()

    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(100):
        req = tree_map(lambda x: x.detach().requires_grad_(True), params)
        g = dict(zip(req, torch.autograd.grad(loss(req), list(req.values()))))
        params, state = opt.update(params, g, state)
    assert float(loss(params)) < 0.05 * l0


def _loaders(jcfg, tcfg):
    return (JDataLoader(jcfg, batch_size=8, num_batches=2, seed=0),
            DataLoader(tcfg, batch_size=8, num_batches=2, seed=0))


def _run_both(algo, kw):
    jcfg, tcfg = _cfgs()
    jmod, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    jcls, tcls = {"ensemble": (JDeepEnsemble, DeepEnsemble),
                  "svgd": (JSteinVGD, SteinVGD)}[algo]
    jl, tl = _loaders(jcfg, tcfg)
    jalgo = jcls(jmod, backend="compiled", capacity=CAP)
    talgo = tcls(tmod, backend="compiled", capacity=CAP, device="cpu")
    jpids, jloss = jalgo.bayes_infer(jl, EPOCHS, num_particles=N,
                                     **kw(jsgd))
    tpids, tloss = talgo.bayes_infer(tl, EPOCHS, num_particles=N,
                                     **kw(sgd))
    assert talgo.store.capacity == CAP and len(tpids) == N
    assert float(talgo.store.active_mask().sum()) == N
    return jalgo, talgo, jloss, tloss


@pytest.mark.parametrize("algo,kw", [
    ("ensemble", lambda opt: {"optimizer": opt(LR)}),
    ("svgd", lambda opt: {"lr": LR, "lengthscale": 0.0}),
    ("svgd", lambda opt: {"lr": LR, "lengthscale": 1.0}),
], ids=["deep-ensemble", "svgd-median", "svgd-ell1"])
def test_fused_training_matches_jax(algo, kw):
    jalgo, talgo, jloss, tloss = _run_both(algo, kw)
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        assert np.abs(_flat_torch(tp) - _flat_jax(jp)).max() < 1e-4
    # dead slots stay frozen zeros
    stacked = talgo.store.stacked("params")
    for leaf in (x for _, x in _paths(stacked)):
        assert torch.count_nonzero(leaf[N:]) == 0
    # the BMA prediction over the trained particles
    batch = next(iter(JDataLoader(jalgo.module.cfg, batch_size=6,
                                  num_batches=1, seed=9)))
    want = np.asarray(jalgo.posterior_pred(batch))
    got = talgo.posterior_pred(batch)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_actor_backend_is_the_default():
    """``backend="nel"``, the reference's default, trains through the
    port's NEL and predicts through it; a bad backend still raises."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, 2))
    with DeepEnsemble(tmod, device="cpu") as algo:  # the reference's default
        assert algo.backend == "nel"
        pids, losses = algo.bayes_infer(_loaders(jcfg, tcfg)[1], 1,
                                        optimizer=sgd(0.1), num_particles=2)
        assert len(pids) == 2 and np.isfinite(losses).all()
        batch = next(iter(DataLoader(tcfg, batch_size=3, num_batches=1)))
        pred = algo.posterior_pred(batch)
        assert pred.shape == (3, tcfg.vocab_size)
        assert torch.isfinite(pred).all()
        st = algo.push_dist.stats()
        assert st["backend"] == "nel"
        assert st["dispatch"]["dispatches"] == 2 * 2 + 2    # steps, forwards
    with pytest.raises(ValueError, match="backend"):
        PushDistribution(tmod, backend="xla", device="cpu")
