"""``PredictiveEngine(stateful=True)`` over the port's recurrent LMs
(zamba2-1.2b, rwkv6-7b) against the reference's engine, on the CPU.

At each arch's ``smoke()`` size, 2 particles of the reference's init
(carried over as numpy): the engine's state is born by a dense
``api.prefill`` (the mamba and rwkv layers' scan states, the shared
block's k/v caches), and 4 greedy steps update it in place; every step's
heads within 1e-4 of the reference's engine, the tokens equal. The same
on a data mesh of two CPU positions, one particle each, the state built
and stepped per position.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.serve import PredictiveEngine as JEngine
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.store import Placement, Sharded
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.launch import make_bench_mesh
from repro_torch.models import api as tapi
from repro_torch.serve import PredictiveEngine
from test_torch_recurrent_lm import (  # noqa: F401 (autouse fixture)
    ARCHS, P, _cfgs, _jax_module, _one_thread)

L, NEW = 9, 4


def _prompts(vocab):
    return np.random.default_rng(2).integers(1, vocab, (2, L)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    """The reference engine's run over its PushDistribution(seed=0)'s 2
    particles: (their stacked params as numpy, each step's heads)."""
    jcfg = _cfgs(name)[0]
    prompts = _prompts(jcfg.vocab_size)
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg), store=jpd.store,
            stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + NEW)[1])
        stacked = jax.tree.map(np.asarray, jpd.store.stacked("params"))
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(NEW):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    return stacked, jheads


def _lm_forward(cfg):
    def fwd(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], cfg)
    return fwd


def _port_engine_matches(name, placement=None):
    jcfg, tcfg = _cfgs(name)
    stacked, jheads = _jax_engine(name)
    tparams = params_from_numpy(stacked)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu",
                          placement=placement)
    try:
        for p in range(P):
            pd.p_create(params=tree_map(lambda a: a[p], tparams))
        eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store,
                               stateful=True)
        toks = torch.from_numpy(_prompts(jcfg.vocab_size))
        state = eng.init_state(lambda p: tapi.prefill(
            p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + NEW)[1])
        assert isinstance(state, Sharded) == (placement is not None)
        tok = toks[:, -1]
        for step in range(NEW):
            heads, state = eng.step(state, {"token": tok,
                                            "cur_pos": L - 1 + step})
            for k, want in jheads[step].items():
                assert np.abs(heads[k].numpy() - want).max() < 1e-4, (step,
                                                                      k)
            tok = heads["mean"].argmax(-1).to(torch.int32)
            assert np.array_equal(tok.numpy(), jheads[step]["mean"].argmax(
                -1))
        eng.close()
    finally:
        pd.cleanup()


@pytest.mark.parametrize("name", ARCHS)
def test_stateful_engine_matches_jax_engine(name):
    _port_engine_matches(name)


@pytest.mark.parametrize("name", ARCHS)
def test_stateful_engine_on_a_data_mesh_matches_jax_engine(name):
    _port_engine_matches(name, Placement(mesh=make_bench_mesh(
        2, devices=["cpu"] * 2)))
