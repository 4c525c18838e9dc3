"""The port's MultiSWAG training, SWAG sampling and BMA serving against
the JAX package, on the CPU.

Same weights and batches in both packages (see ``test_torch_train.py``),
on the ViT-MNIST config at a tiny width, 6 particles in a store of
capacity 8 so the active mask is live:

  * fused MultiSWAG, 2 epochs x 2 batches with ``sgd``, collecting after
    each (two moments per slot, so the diagonal scale is not rounding
    noise): params, losses and the SWAG state (counts, moments, the
    deviation ring, ranks) within 1e-4;
  * ``swag_sample`` with the reference's own noise (the same key splits
    as ``repro.bdl.swag.swag_sample``), 1e-5, through the entry point
    and with the plain diagonal scale passed past the kernel's dispatch;
  * ``posterior_predictive(samples_per_particle=3)`` heads with the
    reference's noise, and ``p_predict``, 1e-4;
  * ``PredictiveEngine`` on a static tree: classify and regress heads
    against the reference engine, 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import swag_sample as jswag_sample
from repro.core import ParticleModule as JModule
from repro.data import DataLoader as JDataLoader
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro_torch import configs as tconfigs
from repro_torch.bdl import MultiSWAG, swag_sample, swag_state_init
from repro_torch.bdl.swag import _sample, diag_scales
from repro_torch.core import ParticleModule
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import api as tapi
from repro_torch.optim import sgd
from repro_torch.serve import PredictiveEngine

TINY = dict(n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128)
N, CAP, EPOCHS, LR, RANK, S = 6, 8, 2, 0.05, 3, 3


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
    elif tree is not None:
        yield prefix, tree


def _close(got, want, tol):
    """Every leaf of the port tree within tol of the reference's leaf at
    the same key path."""
    want = dict(_paths(jax.tree.map(np.asarray, want)))
    got = dict(_paths(got))
    assert set(got) == set(want)
    for path in want:
        err = np.abs(got[path].detach().cpu().numpy().astype(np.float64)
                     - want[path]).max()
        assert err < tol, (path, err)


def _modules(jcfg, tcfg, n):
    rng, inits = jax.random.PRNGKey(0), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        inits.append(jax.tree.map(np.asarray, japi.init_params(sub, jcfg)))
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda r: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: japi.loss_fn(p, b, jcfg),
                   lambda p, b: japi.forward(p, b, jcfg)[0], cfg=jcfg)
    tmod = ParticleModule(lambda g: params_from_numpy(next(tit)),
                          lambda p, b: tapi.loss_fn(p, b, tcfg),
                          lambda p, b: tapi.forward(p, b, tcfg)[0], cfg=tcfg)
    return jmod, tmod


def _reference_noise(stacked_state, rng, S):
    """The noise ``repro.bdl.swag.swag_sample_stacked`` draws: sample j of
    particle i takes key i*S + j, split as ``swag_sample`` splits it.
    Returns (z1 tree with (n, S, ...) leaves, z2 (n, S, max_rank))."""
    mean = jax.tree.map(lambda x: x[0], stacked_state["mean"])
    leaves, tdef = jax.tree.flatten(mean)
    n = jax.tree.leaves(stacked_state["n"])[0].shape[0]
    max_rank = jax.tree.leaves(stacked_state["dev"])[0].shape[1]
    keys = jax.random.split(rng, n * S)

    def one(key):
        k1, k2 = jax.random.split(key)
        zks = jax.random.split(k1, len(leaves))
        return ([jax.random.normal(zk, m.shape) for zk, m in zip(zks, leaves)],
                jax.random.normal(k2, (max_rank,)))

    z1, z2 = jax.jit(jax.vmap(one))(keys)
    z1 = tdef.unflatten([np.array(z).reshape((n, S) + m.shape)
                         for z, m in zip(z1, leaves)])
    return z1, np.array(z2).reshape(n, S, max_rank)


@pytest.fixture(scope="module")
def trained():
    jcfg, tcfg = _cfgs()
    jmod, tmod = _modules(jcfg, tcfg, N)
    jl = JDataLoader(jcfg, batch_size=8, num_batches=2, seed=0)
    tl = DataLoader(tcfg, batch_size=8, num_batches=2, seed=0)
    jalgo = JMultiSWAG(jmod, backend="compiled", capacity=CAP)
    talgo = MultiSWAG(tmod, backend="compiled", capacity=CAP, device="cpu")
    kw = dict(num_particles=N, pretrain_epochs=0, max_rank=RANK)
    _, jloss = jalgo.bayes_infer(jl, EPOCHS, optimizer=jsgd(LR), **kw)
    _, tloss = talgo.bayes_infer(tl, EPOCHS, optimizer=sgd(LR), **kw)
    return jalgo, talgo, jloss, tloss


def test_multiswag_training_matches_jax(trained):
    jalgo, talgo, jloss, tloss = trained
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        _close(tp, jp, 1e-4)
    jswag, tswag = jalgo.store.dense("swag"), talgo.store.dense("swag")
    assert tuple(tswag["n"].shape) == (N,)
    _close(tswag, jswag, 1e-4)
    assert np.array_equal(tswag["rank"].numpy(), np.full(N, EPOCHS))
    # the padding slots were never touched
    padded = talgo.store.stacked("swag")
    for _, leaf in _paths(padded):
        assert torch.count_nonzero(leaf[N:]) == 0


@pytest.mark.parametrize("plain", [True, False])
def test_swag_sample_matches_jax_with_its_noise(trained, plain):
    jalgo = trained[0]
    # The reference's own state on both sides, and the reference run
    # eagerly: where a leaf barely moved (the LayerNorm scales), sq - mean^2
    # is rounding noise, so 1-ulp differences in the trained moments, or
    # the jitted reference contracting s - m*m into one FMA, move its
    # square root by ~1e-4. The port rounds m*m first, as eager XLA does.
    jswag = jax.tree.map(lambda x: x[2], jalgo.store.dense("swag"))
    tswag = params_from_numpy(jax.tree.map(np.array, jswag))
    rng = jax.random.PRNGKey(11)
    # _reference_noise splits rng into one key per sample first
    key = jax.random.split(rng, 1)[0]
    want = jswag_sample(jswag, key, 0.7)
    z1, z2 = _reference_noise(jax.tree.map(lambda x: x[None], jswag), rng, 1)
    z1 = params_from_numpy(tree_map(lambda z: z[0, 0], z1))
    z2 = torch.from_numpy(z2[0, 0])
    if plain:       # the plain diagonal scale, past the kernel's dispatch
        one = tree_map(lambda x: x[None], tswag)
        got = tree_map(lambda x: x[0], _sample(
            one, tree_map(lambda z: z[None, None], z1), z2[None, None], 0.7,
            stds=diag_scales(one, ref.diag_std_leaves)))
    else:
        got = swag_sample(tswag, z1, z2, 0.7)
    _close(got, want, 1e-5)
    # the draw is not the mean: both noise terms are live
    assert max(float((got[k] - tswag["mean"][k]).abs().max())
               for k in ("cls", "pos")) > 1e-3


def test_posterior_predictive_and_predict_match_jax(trained):
    jalgo, talgo, _, _ = trained
    batch = next(iter(JDataLoader(jalgo.module.cfg, batch_size=5,
                                  num_batches=1, seed=1)))
    rng = jax.random.PRNGKey(0)
    want = jalgo.posterior_predictive(samples_per_particle=S,
                                      rng=rng).predict_batch(batch)
    noise = _reference_noise(jalgo.store.dense("swag"), rng, S)
    svc = talgo.posterior_predictive(
        samples_per_particle=S,
        noise=(params_from_numpy(noise[0]), torch.from_numpy(noise[1])))
    with svc:
        calls = svc.stats()["engine"]["calls"]
        got = svc.predict_batch(batch)
        # a caller's batch goes straight to the engine: no batcher request
        st = svc.stats()
        assert st["requests"] == 0 and st["engine"]["calls"] == calls + 1
    _close(got, want, 1e-4)
    # S = 0 serves the particle params; p_predict is the mean of logits
    _close(talgo.posterior_predictive().predict_batch(batch),
           jalgo.posterior_predictive().predict_batch(batch), 1e-4)
    assert np.abs(talgo.posterior_pred(batch).numpy()
                  - np.asarray(jalgo.posterior_pred(batch))).max() < 1e-4


def _sample_predict_noise(jalgo, rng, S):
    """The per-draw noise of the reference's ``MultiSWAG.sample_predict``:
    particle by particle, S draws each, ``rng, sub = split(rng)`` a draw,
    ``sub`` split as ``swag_sample`` splits it. A list of (z1, z2)."""
    pd = jalgo.push_dist
    noise = []
    for pid in pd.particle_ids():
        swag = pd.particles[pid].state["swag"]
        leaves, tdef = jax.tree.flatten(swag["mean"])
        max_rank = jax.tree.leaves(swag["dev"])[0].shape[0]
        for _ in range(S):
            rng, sub = jax.random.split(rng)
            k1, k2 = jax.random.split(sub)
            zks = jax.random.split(k1, len(leaves))
            z1 = tdef.unflatten([np.array(jax.random.normal(zk, m.shape))
                                 for zk, m in zip(zks, leaves)])
            noise.append((params_from_numpy(z1), torch.from_numpy(
                np.array(jax.random.normal(k2, (max_rank,))))))
    return noise


def test_sample_predict_matches_jax_with_its_draws(trained):
    """``MultiSWAG.sample_predict`` against the reference's on the same
    trained state (two collections, so a draw is not the mean), fed the
    reference's own draws: the mean of the raw logits within 1e-5."""
    jalgo, talgo, _, _ = trained
    batch = next(iter(JDataLoader(jalgo.module.cfg, batch_size=4,
                                  num_batches=1, seed=5)))
    rng = jax.random.PRNGKey(7)
    want = jalgo.sample_predict(batch, samples_per_particle=2, rng=rng,
                                scale=0.5)
    noise = _sample_predict_noise(jalgo, rng, 2)
    assert len(noise) == 2 * N
    # shared SWAG state: the reference's, in the port's store for this
    # test (the packages' trained moments differ by up to ~1e-4, which
    # moves the diagonal scale where a leaf barely moved)
    own = talgo.store.checkout("swag")
    talgo.store.commit("swag", params_from_numpy(
        jax.tree.map(np.array, jalgo.store.stacked("swag"))))
    try:
        got = talgo.sample_predict(batch, samples_per_particle=2,
                                   scale=0.5, noise=noise)
        # with a generator: deterministic per seed, and not these draws
        a, b = (talgo.sample_predict(
            batch, samples_per_particle=2,
            generator=torch.Generator().manual_seed(1)) for _ in range(2))
    finally:
        talgo.store.commit("swag", own)
    assert got.shape == (4, jalgo.module.cfg.vocab_size)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    # the mean of raw logits (not of probabilities), and not the logits
    # of the mean params
    assert not np.allclose(got.sum(-1).numpy(), 1.0)
    assert np.abs(got.numpy() - talgo.posterior_pred(batch).numpy()
                  ).max() > 1e-3
    assert torch.equal(a, b) and not torch.equal(a, got)


@pytest.mark.parametrize("kind", ["classify", "regress"])
def test_static_engine_heads_match_jax(kind):
    jcfg, tcfg = _cfgs()
    stacked = jax.vmap(lambda k: japi.init_params(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(2), 3))
    batch = next(iter(JDataLoader(jcfg, batch_size=3, num_batches=1,
                                  seed=2)))
    jeng = JPredictiveEngine(lambda p, b: japi.forward(p, b, jcfg)[0],
                             params=stacked, kind=kind)
    teng = PredictiveEngine(lambda p, b: tapi.forward(p, b, tcfg)[0],
                            params=params_from_numpy(
                                jax.tree.map(np.asarray, stacked)),
                            kind=kind)
    _close(teng.predict(batch), jeng.predict(batch), 1e-4)
    with pytest.raises(ValueError, match="exactly one"):
        PredictiveEngine(lambda p, b: p, kind=kind)


def test_swag_state_init_matches_jax():
    jcfg, _ = _cfgs()
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    from repro.bdl import swag_state_init as jswag_state_init
    want = jswag_state_init(params, max_rank=4)
    got = swag_state_init(params_from_numpy(jax.tree.map(np.asarray, params)),
                          max_rank=4)
    _close(got, want, 0.0 + 1e-12)
    leaves, _ = tree_flatten(got)
    assert got["rank"].dtype == torch.int32 and got["n"].dtype == torch.float32
    assert all(x.dtype in (torch.float32, torch.int32) for x in leaves)
