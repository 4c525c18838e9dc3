"""The port's launch MultiSWAG, prefill and serve steps
(``repro_torch.launch.steps``) against the reference's
(``repro.launch.steps``), at a tiny qwen in fp32 on the CPU, built as
``test_torch_launch_steps.py`` builds them (its helpers). Tolerances:

  * MultiSWAG (sgd, so every moment is held): moments within 1e-5, the
    ring, count and rank;
  * prefill and serve: logits and the caches' K/V within 1e-4, slot
    positions equal (``test_torch_dense_decode.py``'s tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.bdl.swag import swag_state_init as jswag_init
from repro.launch import steps as JS
from repro.models import api as japi
from repro.optim import make_optimizer
from repro_torch.interop import params_from_numpy
from repro_torch.launch import steps as TS
from test_torch_launch_steps import (  # noqa: F401 (autouse fixture)
    P, S, _batch, _cfgs, _init, _meshes, _np, _one_thread, _paths, _plans,
    _tpaths)


def test_multiswag_step_matches_reference():
    jcfg, tcfg = _cfgs(optimizer="sgd")
    jplan, tplan = _plans("train_4k", microbatches=2)
    jm, tm = _meshes()
    stacked = _init(jcfg)
    jb, tb = _batch(jcfg)
    opt = make_optimizer("sgd", 1e-3)
    one = jax.tree.map(lambda x: x[0], stacked)
    jsw = jax.vmap(lambda _: jswag_init(one, TS.SWAG_RANK))(jnp.arange(P))
    with jax.set_mesh(jm):
        jp, _, jsw, jloss = jax.jit(JS.make_multiswag_train_step(
            jcfg, jplan, jm))(stacked, jax.vmap(opt.init)(stacked), jsw, jb)
    tparams = params_from_numpy(_np(stacked))
    tsw = TS.abstract_swag_state(tparams)
    tp, _, tsw, tloss = TS.make_multiswag_train_step(tcfg, tplan, tm)(
        tparams, TS.abstract_opt_state(tcfg, tplan, tparams), tsw, tb)
    assert np.abs(tloss.numpy() - np.asarray(jloss)).max() < 1e-4
    want, got = _paths(jsw), _tpaths(tsw)
    assert set(want) == set(got)
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert np.abs(got[path] - want[path]).max() < 1e-5, path
    assert tsw["n"].tolist() == [1.0] * P and tsw["rank"].tolist() == [1] * P


def test_prefill_and_serve_steps_match_reference():
    jcfg, tcfg = _cfgs()
    jplan, tplan = _plans("decode_32k")
    jm, tm = _meshes()
    stacked = _init(jcfg)
    jb, tb = _batch(jcfg, 3)
    jb.pop("labels"), tb.pop("labels")
    with jax.set_mesh(jm):
        jl, jc = jax.jit(JS.make_prefill_step(jcfg, jplan, jm))(stacked, jb)
    tparams = params_from_numpy(_np(stacked))
    tl, tc = TS.make_prefill_step(tcfg, tplan, tm)(tparams, tb)
    assert tl.dtype == torch.float32 and tl.shape == (3, jcfg.vocab_size)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    assert np.abs(tc["units"][0]["k"].numpy()
                  - np.asarray(jc["units"][0]["k"])).max() < 1e-4
    # the serve step one token past a prompt prefilled with headroom
    jl, jc = jax.vmap(lambda p: japi.prefill(p, jb, jcfg, max_len=S + 2))(
        stacked)
    _, tc = TS.api.prefill(tparams, tb, tcfg, max_len=S + 2)
    tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
    with jax.set_mesh(jm):
        jl, jc = jax.jit(JS.make_serve_step(jcfg, jplan, jm))(
            stacked, jnp.asarray(tok), jc, jnp.int32(S))
    tl, tc = TS.make_serve_step(tcfg, tplan, tm)(
        tparams, torch.from_numpy(tok), tc, torch.tensor(S))
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    for name in ("k", "v"):
        assert np.abs(tc["units"][0][name].numpy()
                      - np.asarray(jc["units"][0][name])).max() < 1e-4
    jpos = np.asarray(jc["units"][0]["pos"])           # (P, n_units, B, C)
    assert np.array_equal(tc["units"][0]["pos"].numpy(), jpos[0])
