"""Training the port's recurrent LMs (zamba2-1.2b, rwkv6-7b) against the
JAX package, on the CPU.

Both packages train the same particles (the reference's inits, carried
over as numpy) on the same ``lm_batch`` loader, at each arch's
``smoke()`` size, 2 particles, 2 batches of 2 x 40 tokens (rwkv's
32-token chunk pads the second chunk), sgd 0.05. Against the reference's
single-device compiled run, losses and params within 1e-4:

  * the fused DeepEnsemble and SteinVGD (median lengthscale) epochs;
  * the port's NEL (``backend="nel"``) DeepEnsemble;
  * the fused DeepEnsemble on a data mesh of two CPU positions
    (``make_bench_mesh(2, devices=["cpu"] * 2)``).

MultiSWAG on these stacks is ``tests/test_torch_recurrent_swag.py``'s.
"""
import functools

import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import SteinVGD as JSteinVGD
from repro.data import DataLoader as JDataLoader
from repro.optim import sgd as jsgd
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.core.store import Placement, Sharded
from repro_torch.data import DataLoader
from repro_torch.launch import make_bench_mesh
from repro_torch.optim import sgd
from test_torch_recurrent_lm import ARCHS, P, _cfgs, _inits
from test_torch_train import _flat_jax, _flat_torch, _modules

LR = 0.05
LOADER = dict(batch_size=2, seq_len=40, num_batches=2, seed=0)
ALGOS = {
    "ensemble": (DeepEnsemble, JDeepEnsemble,
                 lambda opt: {"optimizer": opt(LR)}, 1),
    "svgd": (SteinVGD, JSteinVGD,
             lambda opt: {"lr": LR, "lengthscale": 0.0}, 1),
    "multiswag": (MultiSWAG, JMultiSWAG,
                  lambda opt: {"optimizer": opt(LR), "max_rank": 2,
                               "pretrain_epochs": 0}, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's many small ops: on a shared CPU
    a pool of threads waits on its slowest member (steps of 0.1 s took up
    to 10 s with 8 threads). Values do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref(name, algo):
    """The reference's compiled run, once per (arch, algorithm): (losses,
    each particle's flat params, each particle's flat SWAG mean or
    None)."""
    _, jcls, kw, epochs = ALGOS[algo]
    jcfg, tcfg = _cfgs(name)
    jmod = _modules(jcfg, tcfg, _inits(name))[0]
    jalgo = jcls(jmod, backend="compiled", capacity=P)
    _, jloss = jalgo.bayes_infer(JDataLoader(jcfg, **LOADER), epochs,
                                 num_particles=P, **kw(jsgd))
    swag = [p.state.get("swag") for p in
            (jalgo.push_dist.particles[i]
             for i in jalgo.push_dist.particle_ids())]
    return (np.array(jloss), [_flat_jax(p) for p in jalgo.p_parameters()],
            [None if s is None else _flat_jax(s["mean"]) for s in swag])


def _run(name, algo, **port_kw):
    """The port's run (``port_kw``: its backend or placement), held to the
    reference's: losses and params within 1e-4. Returns the algorithm."""
    tcls, _, kw, epochs = ALGOS[algo]
    jcfg, tcfg = _cfgs(name)
    tmod = _modules(jcfg, tcfg, _inits(name))[1]
    talgo = tcls(tmod, capacity=P, device="cpu",
                 **{"backend": "compiled", **port_kw})
    _, tloss = talgo.bayes_infer(DataLoader(tcfg, **LOADER), epochs,
                                 num_particles=P, **kw(sgd))
    jloss, jparams, _ = _ref(name, algo)
    assert np.abs(np.array(tloss) - jloss).max() < 1e-4
    for jp, tp in zip(jparams, talgo.p_parameters()):
        assert np.abs(_flat_torch(tp) - jp).max() < 1e-4
    return talgo


@pytest.mark.parametrize("algo", ["ensemble", "svgd"])
@pytest.mark.parametrize("name", ARCHS)
def test_fused_training_matches_jax(name, algo):
    _run(name, algo).cleanup()


@pytest.mark.parametrize("name", ARCHS)
def test_nel_ensemble_matches_jax(name):
    _run(name, "ensemble", backend="nel").cleanup()


@pytest.mark.parametrize("name", ARCHS)
def test_data_mesh_ensemble_matches_jax(name):
    mesh = Placement(mesh=make_bench_mesh(2, devices=["cpu"] * 2))
    talgo = _run(name, "ensemble", placement=mesh)
    assert isinstance(talgo.store.stacked("params"), Sharded)
    talgo.cleanup()
