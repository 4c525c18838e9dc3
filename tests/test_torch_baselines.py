"""The port's Fig. 4 baselines (``repro_torch.bdl.baselines``) against the
reference's (``repro.bdl.baselines``), on the CPU, for both of the
paper's workloads at small sizes: the UNet-advection smoke config cut to
d_model 8 on a 16-point grid, and the tiny ViT-MNIST of
``tests/test_torch_train.py``.

Shared params: each package's module hands out the same carried-over
trees in order from ``init`` (the reference draws NN i from its own key
split, the port from one seeded generator; the trees decide). Bars:
ensemble params within 1e-5 (sgd with momentum, as ``tests/test_bdl.py``
holds its baseline: Adam's first update is about sign(g), so a rounding
at an entry where |g| is near eps moves it by up to 2 lr), SVGD params within 2e-4 relative
(the force's bar; ell = 1 and the median heuristic), SWAG moments and
the deviation ring within 1e-5, with equal counts and ranks. Then the
port's ensemble baseline against the port's fused DeepEnsemble from the
same seed (``tests/test_bdl.py``'s check), 1e-5, and each baseline's
programs: one per NN (a graph binds its NN's addresses), looked up once
per run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from repro import configs as jconfigs
from repro.bdl import baselines as jbaselines
from repro.core import ParticleModule as JModule
from repro.data import DataLoader as JDataLoader
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, baselines
from repro_torch.core import ParticleModule
from repro_torch.core.functional import flatten_rows
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.optim import sgd
from repro_torch.runtime.cache import global_cache

N, EPOCHS = 3, 2
WORKLOADS = {
    "unet": ("unet-advection", dict(d_model=8, n_units=2, max_seq_len=16)),
    "vit": ("vit-mnist", dict(n_units=2, d_model=64, n_heads=4,
                              n_kv_heads=4, head_dim=16, d_ff=128)),
}


def _cfgs(workload):
    name, kw = WORKLOADS[workload]
    return (jconfigs.get(name).smoke().replace(**kw),
            tconfigs.get(name).smoke().replace(**kw))


def _setup(workload, n=N):
    """(jcfg, tcfg, reference module, port module, the numpy inits): both
    modules' inits hand out the same n numpy trees in order."""
    jcfg, tcfg = _cfgs(workload)
    init = jax.jit(lambda k: japi.init_params(k, jcfg))
    inits = [jax.tree.map(np.asarray, init(k))
             for k in jax.random.split(jax.random.PRNGKey(5), n)]
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: japi.loss_fn(p, b, jcfg),
                   lambda p, b: japi.forward(p, b, jcfg)[0], cfg=jcfg)
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)),
                          lambda p, b: tapi.loss_fn(p, b, tcfg),
                          lambda p, b: tapi.forward(p, b, tcfg)[0], cfg=tcfg)
    return jcfg, tcfg, jmod, tmod, inits


def _loaders(jcfg, tcfg):
    return (JDataLoader(jcfg, batch_size=4, num_batches=2, seed=1),
            DataLoader(tcfg, batch_size=4, num_batches=2, seed=1))


def _flat(tree):
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        return np.asarray(ravel_pytree(tree)[0])
    return flatten_rows([tree])[0][0].numpy()


def _programs(run):
    """``run()`` with the process cache's stats read around it: (its
    result, misses, hits) of the baseline's programs."""
    before = global_cache().snapshot_stats()
    out = run()
    after = global_cache().snapshot_stats()
    return out, after["misses"] - before["misses"], \
        after["hits"] - before["hits"]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_ensemble_baseline_matches_jax(workload):
    jcfg, tcfg, jmod, tmod, inits = _setup(workload)
    jl, tl = _loaders(jcfg, tcfg)
    jp, jloss = jbaselines.ensemble_baseline(jmod, jsgd(0.05, momentum=0.9), N, jl,
                                             EPOCHS)
    (tp, tloss), misses, hits = _programs(
        lambda: baselines.ensemble_baseline(tmod, sgd(0.05, momentum=0.9), N, tl, EPOCHS,
                                            device="cpu"))
    assert (misses, hits) == (N, 0)          # one program a NN, one lookup
    assert len(tp) == N and isinstance(tloss[0], float)
    assert np.abs(np.array(tloss) / np.array(jloss) - 1).max() < 1e-5
    for a, b in zip(jp, tp):
        assert np.abs(_flat(a) - _flat(b)).max() < 1e-5


@pytest.mark.parametrize("workload,ell", [("unet", 0.0), ("unet", 1.0),
                                          ("vit", 0.0)])
def test_svgd_baseline_matches_jax(workload, ell):
    jcfg, tcfg, jmod, tmod, inits = _setup(workload)
    jl, tl = _loaders(jcfg, tcfg)
    jp = jbaselines.svgd_baseline(jmod, N, jl, EPOCHS, lr=0.05,
                                  lengthscale=ell)
    tp, misses, hits = _programs(
        lambda: baselines.svgd_baseline(tmod, N, tl, EPOCHS, lr=0.05,
                                        lengthscale=ell, device="cpu"))
    assert (misses, hits) == (N + 1, 0)      # a grad a NN, one update
    for a, b, init in zip(jp, tp, inits):
        want, got = _flat(a), _flat(b)
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-4
        assert np.abs(got - _flat(params_from_numpy(init))).max() > 1e-4


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_multiswag_baseline_matches_jax(workload):
    jcfg, tcfg, jmod, tmod, inits = _setup(workload)
    jl, tl = _loaders(jcfg, tcfg)
    jp, js = jbaselines.multiswag_baseline(jmod, jsgd(0.05), N, jl, 3,
                                           pretrain_epochs=1, max_rank=4)
    (tp, ts), misses, hits = _programs(
        lambda: baselines.multiswag_baseline(tmod, sgd(0.05), N, tl, 3,
                                             pretrain_epochs=1, max_rank=4,
                                             device="cpu"))
    assert (misses, hits) == (2 * N, 0)      # a step and a collection a NN
    for a, b in zip(jp, tp):
        assert np.abs(_flat(a) - _flat(b)).max() < 1e-5
    for a, b in zip(js, ts):
        assert float(b["n"]) == float(a["n"]) == 2.0
        assert int(b["rank"]) == int(a["rank"]) == 2
        assert tuple(b["n"].shape) == ()
        for key in ("mean", "sq_mean", "dev"):
            assert np.abs(_flat(a[key]) - _flat(b[key])).max() < 1e-5, key


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_ensemble_baseline_equals_fused_path(workload):
    """Sequential NNs == the fused stacked step, from one seed's inits
    (the port's own ``module.init``, the generator order of
    ``PushDistribution(seed=7)``)."""
    _, tcfg = _cfgs(workload)
    module = ParticleModule(init=lambda g: tapi.init_params(g, tcfg),
                            loss=lambda p, b: tapi.loss_fn(p, b, tcfg),
                            forward=lambda p, b: tapi.forward(p, b, tcfg)[0],
                            cfg=tcfg)
    opt = sgd(0.05)

    def data():
        return DataLoader(tcfg, batch_size=4, num_batches=2, seed=3)

    got, _ = baselines.ensemble_baseline(module, opt, N, data(), 2, seed=7,
                                         device="cpu")
    algo = DeepEnsemble(module, backend="compiled", seed=7, device="cpu")
    algo.bayes_infer(data(), 2, optimizer=opt, num_particles=N)
    for a, b in zip(got, algo.p_parameters()):
        assert np.abs(_flat(a) - _flat(b)).max() < 1e-5
    # not the init: both trained
    fresh = baselines.ensemble_baseline(module, opt, N, [], 1, seed=7,
                                        device="cpu")[0]
    assert np.abs(_flat(fresh[0]) - _flat(got[0])).max() > 1e-4
