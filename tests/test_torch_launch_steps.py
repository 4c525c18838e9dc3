"""The port's launch train steps (``repro_torch.launch.steps``) against
the reference's (``repro.launch.steps``), at a tiny qwen in fp32 on the
CPU: the ensemble (Adam) and SVGD steps. The MultiSWAG, prefill and serve
steps are in ``test_torch_launch_serve_steps.py``, which shares this
file's helpers.

The reference's steps are built on a 1 x 1 mesh and jitted, as
``tests/test_launch.py`` builds them; the weights come from its init
through ``repro_torch.interop``. Tolerances:

  * train (Adam, microbatches 2): losses within 1e-4; new params within
    1e-4 where the first |g| > 1e-5 (Adam's first step is sign-like
    below it, as in ``test_torch_lm_train.py``);
  * SVGD (lr 1): the update (new - old params) within 2e-4 of the
    reference's largest, per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.bdl.swag import swag_state_init as jswag_init
from repro.configs import INPUT_SHAPES
from repro.launch import mesh as jmesh
from repro.launch import steps as JS
from repro.launch.plans import plan_for as jplan_for
from repro.models import api as japi
from repro.optim import make_optimizer
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import make_mesh, steps as TS
from repro_torch.launch.plans import plan_for
from repro_torch.sharding.rules import named_leaves

TINY = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=128)
P, B, S = 2, 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (jconfigs.get("qwen1.5-0.5b").replace(**TINY, **kw),
            tconfigs.get("qwen1.5-0.5b").replace(**TINY, **kw))


def _plans(shape, **kw):
    full = jconfigs.get("qwen1.5-0.5b")
    jp = dataclasses.replace(jplan_for(full, INPUT_SHAPES[shape]),
                             particles=P, **kw)
    tp = dataclasses.replace(plan_for(tconfigs.get("qwen1.5-0.5b"),
                                      INPUT_SHAPES[shape]), particles=P, **kw)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    return jp, tp


def _meshes():
    return (jmesh.make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model"), ["cpu"]))


def _init(jcfg):
    return jax.vmap(lambda k: japi.init_params(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), P))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree):
    return {p: np.asarray(x) for p, x in named_leaves(_np(tree))}


def _tpaths(tree):
    return {p: x.detach().numpy() for p, x in named_leaves(tree)}


def _batch(jcfg, rows=B):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jcfg.vocab_size, (rows, S)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab_size, (rows, S)).astype(np.int32)
    lab[0, :3] = -1
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def test_train_step_matches_reference():
    jcfg, tcfg = _cfgs()
    jplan, tplan = _plans("train_4k", microbatches=2)
    jm, tm = _meshes()
    stacked = _init(jcfg)
    jb, tb = _batch(jcfg)
    opt = make_optimizer(jcfg.optimizer, 1e-3)
    with jax.set_mesh(jm):
        jstep = jax.jit(JS.make_train_step(jcfg, jplan, jm))
        jp, _, jloss = jstep(stacked, jax.vmap(opt.init)(stacked), jb)
    tparams = params_from_numpy(_np(stacked))
    topt = TS.abstract_opt_state(tcfg, tplan, tparams)
    _, g = TS.microbatched_grads(tcfg, tplan)(tparams, tb)
    tp, tstate, tloss = TS.make_train_step(tcfg, tplan, tm)(tparams, topt,
                                                            tb)
    assert np.abs(tloss.numpy() - np.asarray(jloss)).max() < 1e-4
    assert tstate["step"].tolist() == [1] * P
    want, got, grads = _paths(jp), _tpaths(tp), _tpaths(g)
    assert set(want) == set(got)
    for path in want:
        big = np.abs(grads[path]) > 1e-5
        assert big.any(), path
        err = np.abs(got[path] - want[path])[big]
        assert err.max(initial=0.0) < 1e-4, path


def test_svgd_step_matches_reference():
    jcfg, tcfg = _cfgs()
    jplan, tplan = _plans("train_4k", microbatches=2)
    jm, tm = _meshes()
    stacked = _init(jcfg)
    jb, tb = _batch(jcfg)
    # lr 1: the update stands well above the params' rounding
    with jax.set_mesh(jm):
        jp, jloss = jax.jit(JS.make_svgd_train_step(jcfg, jplan, jm,
                                                    lr=1.0))(stacked, jb)
    tparams = params_from_numpy(_np(stacked))
    tp, tloss = TS.make_svgd_train_step(tcfg, tplan, tm, lr=1.0)(tparams,
                                                                 tb)
    assert np.abs(tloss.numpy() - np.asarray(jloss)).max() < 1e-4
    old, want, got = _paths(stacked), _paths(jp), _tpaths(tp)
    for path in want:
        dw, dg = want[path] - old[path], got[path] - old[path]
        assert np.abs(dg - dw).max() <= 2e-4 * np.abs(dw).max(), path
