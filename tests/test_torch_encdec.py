"""whisper-medium's encoder-decoder (family "audio") on the port against
the JAX package, on the CPU.

Both packages run the same weights (the reference initializes them; they
cross over as numpy). At ``smoke()`` size (2 encoder and 2 decoder
layers, d_model 128, 4 heads of 32, 16 stub frames, vocab 512) with
P = 2 particles, checks:

  * the configs equal the reference's, full and smoke; ``make_batch``'s
    frames equal the reference's byte for byte; the port's own init
    builds the reference's tree (the ``encoder`` subtree included);
  * ``forward``, ``loss_fn`` and every leaf's grad: the loss at 1e-5,
    the grads at 1e-4, relative;
  * ``prefill`` and two ``decode_step`` s: logits within 1e-5 of the
    reference's largest logit, every layer's caches (the self-attention
    k / v / pos and the cross k / v) within 1e-5;
  * the cross-attention decode through the plain #6 against the
    reference's jnp ``decode_attention``;
  * the reference's cross-attention query: roped in the prefill, not in
    decode (both packages alike);
  * ``PredictiveEngine(stateful=True)``'s BMA heads against the
    reference's engine (1e-4), the greedy tokens equal;
  * a fused DeepEnsemble epoch and a SteinVGD epoch against the
    reference's compiled runs at 1e-4;
  * the model axis on two CPU positions equal to the one-device port
    (ROADMAP.md queue 1, item 27); the refusals: the precision presets
    (item 21), the paged path, a batch with no frames, a stack with
    decoder layers and no encoder.

The helpers take the arch's name: ``tests/test_torch_prefix_lm.py``
runs the same checks on paligemma-3b.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import SteinVGD as JSteinVGD
from repro.core import PushDistribution as JPD
from repro.data import DataLoader as JDataLoader
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, SteinVGD
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_map
from repro_torch.data import DataLoader
from repro_torch.data import synthetic as tsynthetic
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ref as kref
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import sgd
from repro_torch.serve import PredictiveEngine
from test_torch_recurrent_lm import (  # noqa: F401 (autouse fixture)
    P, _cfgs, _inits, _jax_module, _one_thread, _port_pd, _rel, _stacked,
    model_group)
from test_torch_train import _flat_jax, _flat_torch, _modules, _paths

NAME = "whisper-medium"
S = 12               # prompt / training tokens
NEW = 3              # decode headroom


def _batch(name, B, seq, seed):
    """The reference's ``make_batch`` (tokens, labels and the stub frames
    or patches) as numpy."""
    return jsynthetic.make_batch(_cfgs(name)[0], np.random.default_rng(seed),
                                 B, seq)


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _offset(cfg):
    """The positions in front of the text: the vlm's patches."""
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def config_fields_match(name, smoke):
    j, t = jconfigs.get(name), tconfigs.get(name)
    if smoke:
        j, t = j.smoke(), t.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert {f.name for f in dataclasses.fields(t)} <= \
        {f.name for f in dataclasses.fields(j)}
    assert (t.hd, t.n_layers) == (j.hd, j.n_layers)


def batches_match(name):
    jcfg, tcfg = _cfgs(name)
    for seed in (0, 3):
        a = _batch(name, 3, S, seed)
        b = tsynthetic.make_batch(tcfg, np.random.default_rng(seed), 3, S)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def init_tree_matches(name):
    """The port's own init builds the reference's tree, leaf for leaf."""
    _, tcfg = _cfgs(name)
    want = {p: tuple(a.shape) for p, a in _paths(_inits(name)[0])}
    own = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {p: tuple(t.shape) for p, t in _paths(own)} == want
    assert tapi.param_footprint(tcfg) == sum(
        4 * int(np.prod(s)) for s in want.values())


def loss_and_grads_match(name):
    """The smoke model at P = 2: ``forward``'s text positions, the loss at
    1e-5 and every leaf's grad at 1e-4, relative."""
    jcfg, tcfg = _cfgs(name)
    params = _stacked(name)
    batch = _batch(name, 2, S, 1)
    (jloss, _), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg), has_aux=True)))(params)
    jout = jax.jit(jax.vmap(lambda p: japi.forward(p, batch, jcfg)[0]))(
        params)
    tparams, tb = params_from_numpy(params), _torch(batch)
    tout, aux = tapi.forward(tparams, tb, tcfg)
    assert aux == {} and tout.shape == (P, 2, S, tcfg.d_model)
    assert _rel(tout.detach().numpy(), np.asarray(jout)) < 1e-5
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(tparams, tb)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-4, path


@functools.lru_cache(maxsize=None)
def _jax_serving(name, max_len):
    jcfg = _cfgs(name)[0]
    prefill = jax.jit(jax.vmap(lambda p, b: japi.prefill(
        p, b, jcfg, max_len=max_len), in_axes=(0, None)))
    decode = jax.jit(jax.vmap(lambda p, t, c, pos: japi.decode_step(
        p, t, c, pos, jcfg), in_axes=(0, None, 0, None)))
    return prefill, decode


def _serve_batch(name, seed, n=S):
    b = _batch(name, 3, n, seed)
    b.pop("labels")
    return b


def _caches_close(tc, jc, tol):
    """Every cache leaf within ``tol`` of the reference's (the port's slot
    positions carry no particle axis)."""
    got = dict(_paths(tc))
    want = dict(_paths(jax.tree.map(np.asarray, jc)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        if path[-1] == "pos":
            assert np.array_equal(g, w[0]), path
        else:
            assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
                path


def prefill_and_decode_match(name, steps=2):
    """Prefill of 3 prompts (with their frames or patches) and ``steps``
    greedy decode steps: logits within 1e-5 of the reference's largest
    logit, the caches within 1e-5, the greedy tokens equal."""
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(name)
    tparams = params_from_numpy(stacked)
    batch = _serve_batch(name, 6)
    S_all = S + _offset(tcfg)
    jprefill, jdecode = _jax_serving(name, S_all + NEW)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jl, jc = jprefill(jparams, jax.tree.map(jnp.asarray, batch))
    tl, tc = tapi.prefill(tparams, _torch(batch), tcfg, max_len=S_all + NEW)

    def close(t, j):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() < 1e-5 * np.abs(j).max()

    close(tl, jl)
    _caches_close(tc, jc, 1e-5)
    for step in range(steps):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().mean(0).argmax(-1))
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc,
                         jnp.int32(S_all + step))
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  S_all + step, tcfg)
        close(tl, jl)
        _caches_close(tc, jc, 1e-5)


@functools.lru_cache(maxsize=None)
def _jax_engine(name, L, new):
    """The reference engine's run over its PushDistribution(seed=0)'s 2
    particles: (their stacked params as numpy, each step's heads)."""
    jcfg = _cfgs(name)[0]
    batch = _serve_batch(name, 2, L)
    off = _offset(jcfg)
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg), store=jpd.store,
            stateful=True)
        pre = {**{k: jnp.asarray(v) for k, v in batch.items()},
               "tokens": jnp.asarray(batch["tokens"][:, :-1])}
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, pre, jcfg, max_len=off + L + new)[1])
        stacked = jax.tree.map(np.asarray, jpd.store.stacked("params"))
        tok, jheads = jnp.asarray(batch["tokens"][:, -1]), []
        for step in range(new):
            h, jstate = jeng.step(jstate, {
                "token": tok, "cur_pos": jnp.int32(off + L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    return stacked, jheads


def engine_matches(name, L=9, new=4):
    """The stateful engine's state born by a dense ``api.prefill`` (the
    frames or patches shared by the particles), ``new`` greedy steps:
    every head within 1e-4 of the reference engine's, the tokens equal."""
    jcfg, tcfg = _cfgs(name)
    stacked, jheads = _jax_engine(name, L, new)
    batch = _torch(_serve_batch(name, 2, L))
    off = _offset(tcfg)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    try:
        tparams = params_from_numpy(stacked)
        for p in range(P):
            pd.p_create(params=tree_map(lambda a: a[p], tparams))
        eng = PredictiveEngine(
            lambda params, caches, b: tapi.decode_step(
                params, b["token"], caches, b["cur_pos"], tcfg),
            store=pd.store, stateful=True)
        pre = {**batch, "tokens": batch["tokens"][:, :-1]}
        state = eng.init_state(lambda p: tapi.prefill(
            p, pre, tcfg, max_len=off + L + new)[1])
        tok = batch["tokens"][:, -1]
        for step in range(new):
            heads, state = eng.step(state, {"token": tok,
                                            "cur_pos": off + L - 1 + step})
            for k, want in jheads[step].items():
                assert np.abs(heads[k].numpy() - want).max() < 1e-4, (step,
                                                                      k)
            tok = heads["mean"].argmax(-1).to(torch.int32)
            assert np.array_equal(tok.numpy(),
                                  jheads[step]["mean"].argmax(-1))
        eng.close()
    finally:
        pd.cleanup()


LR = 0.05
LOADER = dict(batch_size=2, seq_len=S, num_batches=2, seed=0)
ALGOS = {"ensemble": (DeepEnsemble, JDeepEnsemble,
                      lambda opt: {"optimizer": opt(LR)}),
         "svgd": (SteinVGD, JSteinVGD,
                  lambda opt: {"lr": LR, "lengthscale": 0.0})}


def fused_training_matches(name, algo):
    """One fused epoch of 2 batches (with their frames or patches), sgd:
    losses and params within 1e-4 of the reference's compiled run."""
    tcls, jcls, kw = ALGOS[algo]
    jcfg, tcfg = _cfgs(name)
    jmod, tmod = _modules(jcfg, tcfg, _inits(name))
    jalgo = jcls(jmod, backend="compiled", capacity=P)
    _, jloss = jalgo.bayes_infer(JDataLoader(jcfg, **LOADER), 1,
                                 num_particles=P, **kw(jsgd))
    talgo = tcls(tmod, capacity=P, device="cpu", backend="compiled")
    _, tloss = talgo.bayes_infer(DataLoader(tcfg, **LOADER), 1,
                                 num_particles=P, **kw(sgd))
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        assert np.abs(_flat_torch(tp) - _flat_jax(jp)).max() < 1e-4
    talgo.cleanup()


def refusals(name):
    """What the port refuses on these stacks, as the reference does or
    where no form is ported: the presets other than fp32 (item 21), the
    paged path; a batch without its frontend. The model axis is no
    longer refused (ROADMAP.md queue 1, item 27, done): on a group of two
    CPU positions ``forward`` and ``prefill`` equal the one-device port's
    within 1e-5 relative (``tests/test_torch_placement2d_families.py``
    holds the group to the reference)."""
    jcfg, tcfg = _cfgs(name)
    params = params_from_numpy(_stacked(name))
    batch = _torch(_batch(name, 1, 4, 0))
    group = model_group(params, 2)
    assert _rel(tapi.forward(group, batch, tcfg)[0].numpy(),
                tapi.forward(params, batch, tcfg)[0].numpy()) < 1e-5
    assert _rel(tapi.prefill(group, batch, tcfg)[0].numpy(),
                tapi.prefill(params, batch, tcfg)[0].numpy()) < 1e-5
    with pytest.raises(NotImplementedError, match="item 21"):
        PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu",
                         precision="mixed")
    for pg in (lambda: tapi.paged_cache_init(tcfg, num_pages=2, page_size=4,
                                             device="cpu"),):
        with pytest.raises(NotImplementedError, match="paged decode"):
            pg()
    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda: japi.paged_cache_init(jcfg, num_pages=2,
                                                     page_size=4))
    key = "frames" if tcfg.family == "audio" else "patches"
    no_front = {k: v for k, v in batch.items() if k != key}
    with pytest.raises(ValueError, match=key):
        tapi.loss_fn(params, no_front, tcfg)
    with pytest.raises(KeyError):
        japi.loss_fn(jax.tree.map(lambda a: a[0], _stacked(name)),
                     {k: np.asarray(v) for k, v in no_front.items()}, jcfg)


# ---------------------------------------------------------------------------
# whisper-medium
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_match_jax(smoke):
    config_fields_match(NAME, smoke)


def test_make_batch_frames_identical():
    batches_match(NAME)


def test_init_tree_matches_jax():
    init_tree_matches(NAME)
    assert "encoder" in _inits(NAME)[0]


def test_forward_loss_and_grads_match_jax():
    loss_and_grads_match(NAME)


def test_prefill_and_decode_match_jax():
    prefill_and_decode_match(NAME)


def test_cross_decode_through_plain_kernel_matches_jax():
    """The decoder's cross-attention decode: the plain #6 over every one
    of F slots (``k_pos`` = arange(F)) against the reference's jnp
    ``decode_attention(q, xk, xv, k_pos=arange(F), cur_pos=F)``, and
    ``blocks.cross_attn_decode`` against the reference decode layer's
    cross-attention arithmetic."""
    rng = np.random.default_rng(4)
    F_, B, H, KVH, hd = 16, 3, 4, 2, 32
    q = rng.standard_normal((P, B, 1, H, hd)).astype(np.float32)
    xk, xv = (rng.standard_normal((P, B, F_, KVH, hd)).astype(np.float32)
              for _ in range(2))
    kpos = np.broadcast_to(np.arange(F_, dtype=np.int32), (B, F_))
    got = kref.decode_attention(torch.from_numpy(q[:, :, 0]),
                                torch.from_numpy(xk), torch.from_numpy(xv),
                                torch.from_numpy(kpos.copy())).numpy()
    for p in range(P):
        want = np.asarray(jblocks.decode_attention(
            jnp.asarray(q[p]), jnp.asarray(xk[p]), jnp.asarray(xv[p]),
            k_pos=jnp.asarray(kpos), cur_pos=F_))
        assert np.abs(got[p] - want[:, 0]).max() < 1e-6
    # the layer's cross-attention decode on the smoke weights
    jcfg, tcfg = _cfgs(NAME)
    jp = jax.tree.map(lambda a: a[0, 0], _stacked(NAME)["units"][0]["xattn"])
    tp = tree_map(lambda a: a[:, 0], params_from_numpy(
        _stacked(NAME))["units"][0]["xattn"])
    x = rng.standard_normal((P, B, 1, tcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((P, B, tcfg.n_frames, tcfg.n_kv_heads,
                                   tcfg.hd)).astype(np.float32)
              for _ in range(2))
    got = tblocks.cross_attn_decode(tp, torch.from_numpy(x), tcfg,
                                    torch.from_numpy(ck),
                                    torch.from_numpy(cv)).numpy()
    kp = jnp.broadcast_to(jnp.arange(tcfg.n_frames, dtype=jnp.int32),
                          (B, tcfg.n_frames))
    jq = jblocks.dense_apply(jp["wq"], jnp.asarray(x[0])).reshape(
        B, 1, jcfg.n_heads, jcfg.hd)
    h = jblocks.decode_attention(jq, jnp.asarray(ck[0]), jnp.asarray(cv[0]),
                                 k_pos=kp, cur_pos=tcfg.n_frames)
    want = np.asarray(jblocks.dense_apply(jp["wo"], h.reshape(B, 1, -1)))
    assert np.abs(got[0] - want).max() < 1e-5


def test_cross_query_roped_in_prefill_not_in_decode():
    """The reference ropes the cross-attention query in the prefill
    (``attn_apply_fullseq(..., cross_kv=...)``) and not in decode
    (``layer_apply_decode`` projects q alone), and so does the port: the
    prefill's cross-attention row at position t equals the decode form
    only at t = 0 (RoPE at 0 is the identity), and both packages agree
    on each form."""
    jcfg, tcfg = _cfgs(NAME)
    jp = jax.tree.map(lambda a: a[0, 0], _stacked(NAME)["units"][0]["xattn"])
    tp = tree_map(lambda a: a[:, 0], params_from_numpy(
        _stacked(NAME))["units"][0]["xattn"])
    rng = np.random.default_rng(7)
    B, Sx = 2, 5
    x = rng.standard_normal((P, B, Sx, tcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((P, B, tcfg.n_frames, tcfg.n_kv_heads,
                                   tcfg.hd)).astype(np.float32)
              for _ in range(2))
    tkv = (torch.from_numpy(ck), torch.from_numpy(cv))
    full = tblocks.attn_apply_fullseq(tp, torch.from_numpy(x), tcfg,
                                      cross_kv=tkv).numpy()
    jfull, _ = jblocks.attn_apply_fullseq(
        jp, jnp.asarray(x[0]), jcfg, cross_kv=(jnp.asarray(ck[0]),
                                               jnp.asarray(cv[0])))
    assert np.abs(full[0] - np.asarray(jfull)).max() < 1e-5
    for t in range(Sx):
        dec = tblocks.cross_attn_decode(tp, torch.from_numpy(
            x[:, :, t:t + 1]), tcfg, *tkv).numpy()[:, :, 0]
        gap = np.abs(dec - full[:, :, t]).max()
        assert (gap < 1e-5) if t == 0 else (gap > 1e-3), (t, gap)


def test_stateful_engine_matches_jax_engine():
    engine_matches(NAME)


@pytest.mark.parametrize("algo", ["ensemble", "svgd"])
def test_fused_training_matches_jax(algo):
    fused_training_matches(NAME, algo)


def test_refusals():
    refusals(NAME)
    _, tcfg = _cfgs(NAME)
    params = params_from_numpy(_stacked(NAME))
    batch = _torch(_batch(NAME, 1, 4, 0))
    # frames of another length than the cache's n_frames
    short = {**batch, "frames": batch["frames"][:, :-1]}
    short.pop("labels")
    with pytest.raises(ValueError, match="n_frames"):
        tapi.prefill(params, short, tcfg)
    # decoder layers with no encoder to cross-attend to (the reference
    # fails on its missing ctx["enc_out"])
    no_enc = tcfg.replace(family="dense", is_encoder_decoder=False)
    with pytest.raises(ValueError, match="encoder"):
        tapi.loss_fn({k: v for k, v in params.items() if k != "encoder"},
                     batch, no_enc)
    with pytest.raises(KeyError, match="enc_out"):
        japi.loss_fn(jax.tree.map(lambda a: a[0], _stacked(NAME)),
                     _batch(NAME, 1, 4, 0), _cfgs(NAME)[0].replace(
                         family="dense", is_encoder_decoder=False))
