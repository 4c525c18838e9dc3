"""The port's dense-cache decode path against the JAX package, on the CPU.

Weights come from the reference (the 2-layer tiny qwen config of
``tests/test_speculative.py``) through
``repro_torch.interop.params_from_numpy``. Checks:

  * ``api.prefill`` + 4 x ``api.decode_step`` against the reference's
    (``decode_kernel=True``: its Pallas decode kernel in interpret mode)
    over P = 2: logits within 1e-4; the caches' slot positions and K/V;
  * ``PredictiveEngine(stateful=True)`` against the reference engine on
    the same LM, with 3 live particles in a capacity of 4 (the dead row
    rides along, masked out): heads within 1e-4;
  * the port's dense greedy decode equals the port's paged scheduler
    token for token;
  * ``init_cache`` shapes, and the options the dense path does not port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.serve import PredictiveEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.serve import PredictiveEngine, serve_decode

TINY = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=128)


def _cfgs():
    return (jconfigs.get("qwen1.5-0.5b").replace(**TINY),
            tconfigs.get("qwen1.5-0.5b").replace(**TINY))


def _jax_module(jcfg):
    return JModule(init=lambda r: japi.init_params(r, jcfg),
                   loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                   forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                   cfg=jcfg)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def test_prefill_and_decode_steps_match_jax():
    jcfg, tcfg = _cfgs()
    P, L, steps = 2, 13, 4
    stacked = jax.vmap(lambda k: japi.init_params(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), P))
    tparams = _to_port(stacked)
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, jcfg.vocab_size, (3, L)).astype(np.int32)
    jl, jc = jax.vmap(lambda p: japi.prefill(
        p, {"tokens": jnp.asarray(prompts)}, jcfg, max_len=L + steps + 1))(
        stacked)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L + steps + 1)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4
    for step in range(steps):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        jl, jc = jax.vmap(lambda p, c: japi.decode_step(
            p, jnp.asarray(tok), c, jnp.int32(L + step), jcfg,
            decode_kernel=True))(stacked, jc)
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  L + step, tcfg)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4, step
    # caches: K/V stacked like params, positions shared by the particles
    jk = np.asarray(jc["units"][0]["k"])            # (P, n_units, B, C, ..)
    assert tuple(tc["units"][0]["k"].shape) == jk.shape
    assert np.abs(tc["units"][0]["k"].numpy() - jk).max() < 1e-4
    jpos = np.asarray(jc["units"][0]["pos"])        # (P, n_units, B, C)
    assert np.array_equal(tc["units"][0]["pos"].numpy(), jpos[0])
    assert np.array_equal(jpos[0], jpos[1])


def _lm_forward(cfg):
    def fwd(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], cfg)
    return fwd


def test_stateful_engine_matches_jax_engine():
    """3 live particles in a capacity of 4: the serving state is born
    capacity-padded and the dead row rides along masked out."""
    jcfg, tcfg = _cfgs()
    L, max_new = 10, 4
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, jcfg.vocab_size, (2, L)).astype(np.int32)
    with JPD(_jax_module(jcfg), num_devices=1, seed=0, capacity=4) as jpd:
        for _ in range(3):
            jpd.p_create()
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg, decode_kernel=True),
            store=jpd.store, stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + max_new)[1])
        live = [jax.tree.map(lambda a: np.asarray(a[s]), jpd.store.stacked(
            "params")) for s in range(3)]
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(max_new):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu",
                          capacity=4)
    for row in live:
        pd.p_create(params=params_from_numpy(row))
    eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store, stateful=True)
    with pytest.raises(RuntimeError, match="step"):
        eng.predict({"token": torch.zeros(2, dtype=torch.int32)})
    toks = torch.from_numpy(prompts)
    state = eng.init_state(lambda p: tapi.prefill(
        p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + max_new)[1])
    assert tree_leaves(state)[0].shape[0] == pd.store.capacity == 4
    tok = toks[:, -1]
    for step in range(max_new):
        heads, state = eng.step(state, {"token": tok, "cur_pos": L - 1 + step})
        for k, want in jheads[step].items():
            assert np.abs(heads[k].numpy() - want).max() < 1e-4, (step, k)
        tok = heads["mean"].argmax(-1).to(torch.int32)
    assert eng.snapshot_stats()["calls"] == max_new
    stateless = PredictiveEngine(lambda p, b: None, store=pd.store)
    with pytest.raises(RuntimeError, match="predict"):
        stateless.step(state, {})


def test_dense_greedy_decode_matches_paged_scheduler():
    """The dense-cache path, an oracle with no page pool: its greedy BMA
    tokens equal the paged scheduler's for the same prompts."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    L, max_new = 11, 6
    prompts = rng.integers(1, tcfg.vocab_size, (3, L)).astype(np.int32)
    pd = PushDistribution(ParticleModule(
        init=lambda g: tapi.init_params(g, tcfg), cfg=tcfg), device="cpu")
    for _ in range(2):
        pd.p_create()
    svc = serve_decode(pd, tcfg, num_pages=32, page_size=4, max_active=2)
    try:
        paged = [svc.generate(list(p), max_new=max_new).tokens
                 for p in prompts]
    finally:
        svc.close()
    eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store, stateful=True)
    toks = torch.from_numpy(prompts)
    state = eng.init_state(lambda p: tapi.prefill(
        p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + max_new)[1])
    tok, dense = toks[:, -1], []
    for step in range(max_new):
        heads, state = eng.step(state, {"token": tok, "cur_pos": L - 1 + step})
        tok = heads["mean"].argmax(-1).to(torch.int32)
        dense.append(tok.numpy())
    assert np.stack(dense, 1).tolist() == paged


def test_init_cache_and_unported_options():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: japi.init_cache(jcfg, 3, 17))
    got = tapi.init_cache(tcfg, 3, 17, particles=2, device="cpu")
    for j, t in zip(jax.tree.leaves(want["units"][0]),
                    (got["units"][0]["k"], got["units"][0]["pos"],
                     got["units"][0]["v"])):
        assert tuple(t.shape) == (((2,) if t.dtype != torch.int32 else ())
                                  + tuple(j.shape))
    assert int(got["units"][0]["pos"].max()) == -1
    params = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    params = tree_map(lambda a: a[None], params)
    _, caches = tapi.prefill(params, {"tokens": torch.ones(1, 4,
                                                           dtype=torch.int32)},
                             tcfg, max_len=5)
    with pytest.raises(ValueError, match="outside"):
        tapi.decode_step(params, torch.ones(1, dtype=torch.int32), caches, 5,
                         tcfg)
    # once refused: a prefix-LM flag with no patches (prefix 0: causal)
    # prefills as the reference does; decoder layers with no encoder, and
    # the audio family with no frames, still fail in both packages
    toks = torch.ones(1, 4, dtype=torch.int32)
    jparams = jax.tree.map(lambda t: jnp.asarray(t[0].numpy()), params)
    jlogits, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks.numpy())},
                              jcfg.replace(prefix_lm=True))
    logits, _ = tapi.prefill(params, {"tokens": toks},
                             tcfg.replace(prefix_lm=True))
    assert np.abs(logits[0].numpy() - np.asarray(jlogits)).max() < 1e-5
    for bad, match, jkey in ((dict(pattern=("dec_attn_mlp",)), "encoder",
                              "enc_out"),
                             (dict(family="audio"), "frames", "frames")):
        with pytest.raises(ValueError, match=match):
            tapi.prefill(params, {"tokens": toks}, tcfg.replace(**bad))
        with pytest.raises(KeyError, match=jkey):
            japi.prefill(jparams, {"tokens": jnp.asarray(toks.numpy())},
                         jcfg.replace(**bad))
