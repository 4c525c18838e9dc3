"""The model axis for the recurrent, hybrid, encoder-decoder and prefix-LM
stacks and for a q head that several model positions share, against the
reference's single-device functions, on the CPU.

The reference runs single-device in this process, jitted once per shape;
weights cross over from it as numpy. The port runs a model group of
logical CPU positions, its params split by ``sharding.rules`` as the
store splits them (``model_group``), or a store placed on
``make_bench_mesh(4, model=2, devices=["cpu"] * 4)`` (2 x 2). At each
arch's ``smoke()`` size with 2 particles, held within 1e-4 of the
reference:

  * zamba2-1.2b (Mamba2 + the shared attention block) and rwkv6-7b on 1 x
    2: the loss and every leaf's grad; prefill and greedy decode (logits,
    tokens equal); a fused DeepEnsemble epoch on 2 x 2 against the
    reference's compiled run, every replicated copy bit-equal after it;
    the stateful engine on 2 x 2 against the reference's engine;
  * the scan state across steps: zamba2's ``in_proj`` split on 1 x 2
    cuts across the z / x boundary (asserted), and each position's ssm
    heads and conv channels after a padded 70-token prefill and 4 decode
    steps equal the reference's state's slices;
  * the divisibility drop: 3 heads over 2 positions (rwkv's columns cut
    a head and are joined; zamba2's 419 ``in_proj`` columns stay whole,
    on a unit of one mamba and the shared block), each block run whole
    at every position;
  * whisper-medium (the encoder over the group, the cross k / v per
    position) and paligemma-3b (the patches at every position, the
    prefix mask) on 1 x 2: loss, grads, prefill, decode, tokens;
  * a q head shared by 2 positions (ROADMAP item 31) on 1 x 4: gemma3-4b
    (2 q heads over 1 kv head, a unit of one local and one global
    layer) and paligemma-3b (2 q heads): loss, grads, prefill, decode;
  * one SteinVGD step of zamba2 on 2 x 2 at 2e-4 relative (#1's partial
    distances are summed per shard).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.bdl import SteinVGD as JSteinVGD
from repro.data import DataLoader as JDataLoader
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.bdl import SteinVGD
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.store import Placement
from repro_torch.core.tree import Group, tree_flatten
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.launch import make_bench_mesh
from repro_torch.models import api as tapi
from repro_torch.models import tp, tp_recurrent
from repro_torch.sharding import rules
from test_torch_recurrent_lm import (  # noqa: F401 (autouse fixture)
    _jax_serving, _one_thread, _rel, _stacked, model_group)
from test_torch_recurrent_serve import _port_engine_matches
from test_torch_recurrent_train import _run
from test_torch_train import _flat_jax, _flat_torch, _modules, _paths

S, NEW = 12, 2


def _two():
    return Placement(mesh=make_bench_mesh(4, model=2, devices=["cpu"] * 4))


@functools.lru_cache(maxsize=None)
def _model(name, kw=()):
    """(reference config, port config, 2 particles' stacked params as
    numpy) at the smoke size with ``kw``'s fields replaced; the init
    jitted once."""
    jcfg = jconfigs.get(name).smoke().replace(**dict(kw))
    tcfg = tconfigs.get(name).smoke().replace(**dict(kw))
    stacked = jax.jit(jax.vmap(lambda k: japi.init_params(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    return jcfg, tcfg, jax.tree.map(np.asarray, stacked)


def _joined(group):
    """The whole tree of a group of params (or of their grads)."""
    paths = [p for p, _ in rules.named_leaves(group.shards[0])]
    per = [tree_flatten(s)[0] for s in group.shards]
    unflatten = tree_flatten(group.shards[0])[1]
    return unflatten([rules.join_leaf([p[k] for p in per], group.dims[path])
                      for k, path in enumerate(paths)])


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _offset(cfg):
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def _loss_and_grads_match(name, m, kw=()):
    """The loss within 1e-4 and every leaf's grad within 1e-4 relative of
    the reference's, on a group of ``m``. Returns the group."""
    jcfg, tcfg, stacked = _model(name, kw)
    batch = jsynthetic.make_batch(jcfg, np.random.default_rng(1), 2, S)
    (jloss, _), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg), has_aux=True)))(stacked)
    group = model_group(params_from_numpy(stacked), m)
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(group, _torch(batch))
    assert np.abs(tloss.numpy() - np.asarray(jloss)).max() < 1e-4
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(_joined(tgrads)))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-4, path
    return group


@functools.lru_cache(maxsize=None)
def _jax_steps(name, kw, max_len):
    jcfg = _model(name, kw)[0]
    prefill = jax.jit(jax.vmap(lambda p, b: japi.prefill(
        p, b, jcfg, max_len=max_len), in_axes=(0, None)))
    decode = jax.jit(jax.vmap(lambda p, t, c, pos: japi.decode_step(
        p, t, c, pos, jcfg), in_axes=(0, None, 0, None)))
    return prefill, decode


def _serving_matches(name, group, kw=(), steps=NEW):
    """Prefill of 3 prompts (with the family's frontend) and ``steps``
    greedy BMA decode steps on ``group``: logits within 1e-4 of the
    reference's largest, the greedy tokens equal."""
    jcfg, tcfg, stacked = _model(name, kw)
    batch = jsynthetic.make_batch(jcfg, np.random.default_rng(6), 3, S)
    batch.pop("labels")
    S_all = S + _offset(tcfg)
    jprefill, jdecode = _jax_steps(name, kw, S_all + steps)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jl, jc = jprefill(jparams, jax.tree.map(jnp.asarray, batch))
    tl, tc = tapi.prefill(group, _torch(batch), tcfg, max_len=S_all + steps)
    assert isinstance(tc, Group)

    def close(t, j):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() < 1e-4 * np.abs(j).max()

    close(tl, jl)
    for step in range(steps):
        jtok = jax.nn.softmax(jl, -1).mean(0).argmax(-1).astype(jnp.int32)
        ttok = torch.softmax(tl, -1).mean(0).argmax(-1).to(torch.int32)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), step
        jl, jc = jdecode(jparams, jtok, jc, jnp.int32(S_all + step))
        tl, tc = tapi.decode_step(group, ttok, tc, S_all + step, tcfg)
        close(tl, jl)
    return tc


# ---------------------------------------------------------------------------
# zamba2-1.2b and rwkv6-7b
# ---------------------------------------------------------------------------

RECURRENT = ("zamba2-1.2b", "rwkv6-7b")


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_loss_grads_and_serving_on_a_model_group(name):
    """1 x 2: each position its half of the heads (4 of zamba2's 8 ssm
    heads and 2 of its shared block's 4 q heads; 2 of rwkv's 4 heads)."""
    group = _loss_and_grads_match(name, 2)
    tcfg = _model(name)[1]
    kind = tcfg.pattern[0]
    p0 = group.shards[0]["units"][0]
    assert tp_recurrent.MODES[kind](p0, tcfg, 2) == "heads"
    if name == "zamba2-1.2b":
        assert group.dims["shared/attn/wq/w"] == -1
        assert group.dims["units/0/out_proj/w"] is None
    else:
        assert group.dims["units/0/time_mix/wo/w"] == -2
        assert group.dims["units/0/channel_mix/wr/w"] is None
    tc = _serving_matches(name, group)
    state = tc.shards[0]["units"][0]
    heads = state["ssm" if kind == "mamba" else "state"].shape[-3]
    assert heads * 2 == (8 if kind == "mamba" else 4)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_fused_ensemble_on_2x2(name):
    """A fused DeepEnsemble epoch (sgd, 2 batches) on 2 x 2 against the
    reference's compiled run (losses and params within 1e-4), every
    replicated copy bit-equal after it."""
    talgo = _run(name, "ensemble", placement=_two())
    try:
        st = talgo.store.stacked("params")
        for grp in st.shards:
            assert isinstance(grp, Group) and len(grp) == 2
            first = rules.named_leaves(grp[0])
            for shard in grp.shards[1:]:
                for (path, a), (_, b) in zip(first,
                                             rules.named_leaves(shard)):
                    if grp.dims[path] is None:
                        assert torch.equal(a, b), path
    finally:
        talgo.cleanup()


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_stateful_engine_on_2x2(name):
    """``PredictiveEngine(stateful=True)`` on 2 x 2: 4 greedy steps' heads
    within 1e-4 of the reference's engine, the tokens equal."""
    _port_engine_matches(name, _two())


def test_scan_state_across_steps_with_in_proj_cut_across_z_and_x():
    """zamba2 on 1 x 2: ``in_proj``'s 552 columns split 276 a position,
    so position 0's block holds all of z and 20 columns of x. After a
    70-token prefill (the 64-token chunk pads) and 4 decode steps, each
    position's ssm state is the reference's for its 4 heads and its conv
    state the reference's for its x channels and B and C; the logits
    within 1e-4 relative."""
    from test_torch_recurrent_lm import L_PROMPT, _cfgs
    name = "zamba2-1.2b"
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(name)
    group = model_group(params_from_numpy(stacked), 2)
    d_inner = tcfg.ssm_expand * tcfg.d_model
    cols = group.shards[0]["units"][0]["in_proj"]["w"].shape[-1]
    assert d_inner < cols < 2 * d_inner and cols * 2 == 2 * d_inner + 2 \
        * tcfg.ssm_state + d_inner // tcfg.ssm_head_dim
    prompts = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (3, L_PROMPT)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jprefill, jdecode = _jax_serving(name)
    jl, jc = jprefill(jparams, jnp.asarray(prompts))
    tl, tc = tapi.prefill(group, {"tokens": torch.from_numpy(prompts)}, tcfg,
                          max_len=L_PROMPT + 8)
    for step in range(4):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().mean(0).argmax(-1))
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc,
                         jnp.int32(L_PROMPT + step))
        tl, tc = tapi.decode_step(group, torch.from_numpy(tok), tc,
                                  L_PROMPT + step, tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, step
    H, hd, ds = d_inner // tcfg.ssm_head_dim, tcfg.ssm_head_dim, \
        tcfg.ssm_state
    Hl = H // 2
    for where, j_states in (("units", jc["units"]), ("tail", jc["tail"])):
        for i, js in enumerate(j_states):
            if "ssm" not in js:
                continue
            ssm, conv = np.asarray(js["ssm"]), np.asarray(js["conv"])
            for j in range(2):
                t = tc.shards[j][where][i]
                want = ssm[..., j * Hl:(j + 1) * Hl, :, :]
                assert np.abs(t["ssm"].numpy() - want).max() \
                    < 1e-4 * np.abs(ssm).max(), (where, i, j)
                keep = np.r_[j * Hl * hd:(j + 1) * Hl * hd,
                             d_inner:d_inner + 2 * ds]
                assert np.abs(t["conv"].numpy() - conv[..., keep]).max() \
                    < 1e-4 * np.abs(conv).max(), (where, i, j)


@pytest.mark.parametrize("name,kw,mode", [
    ("rwkv6-7b", (("d_model", 96),), "join"),
    ("zamba2-1.2b", (("d_model", 96), ("ssm_head_dim", 64),
                     ("pattern", ("mamba", "shared_attn")),
                     ("tail_layers", ())), "whole")])
def test_divisibility_drop_runs_the_block_whole(name, kw, mode):
    """3 heads over 2 positions: rwkv's time-mix columns (48 a position)
    cut a head and are joined; zamba2's ``in_proj`` (419 columns) is left
    whole by the rules. Each block runs whole at every position (a
    replicated output): loss, grads, prefill and decode as the
    reference's."""
    group = _loss_and_grads_match(name, 2, kw)
    tcfg = _model(name, kw)[1]
    kind = tcfg.pattern[0]
    assert tp_recurrent.MODES[kind](group.shards[0]["units"][0], tcfg,
                                    2) == mode
    _serving_matches(name, group, kw, steps=2)


def test_svgd_step_on_2x2_zamba2():
    """One SteinVGD step (median lengthscale, one batch) of zamba2 on
    2 x 2: losses and params within 2e-4 relative of the reference's
    compiled step (#1's distances are summed from partial sums per
    shard)."""
    name = "zamba2-1.2b"
    jcfg, tcfg, stacked = _model(name)
    inits = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(2)]
    loader = dict(batch_size=2, seq_len=S, num_batches=1, seed=0)
    jmod, tmod = _modules(jcfg, tcfg, inits)
    jalgo = JSteinVGD(jmod, backend="compiled", capacity=2)
    _, jloss = jalgo.bayes_infer(JDataLoader(jcfg, **loader), 1,
                                 num_particles=2, lr=0.05, lengthscale=0.0)
    with SteinVGD(tmod, backend="compiled", capacity=2, device="cpu",
                  placement=_two()) as talgo:
        _, tloss = talgo.bayes_infer(DataLoader(tcfg, **loader), 1,
                                     num_particles=2, lr=0.05,
                                     lengthscale=0.0)
        assert isinstance(talgo.store.stacked("params").shards[0], Group)
        assert _rel(np.array(tloss), np.array(jloss)) < 2e-4
        for jp, tp_ in zip(jalgo.p_parameters(), talgo.p_parameters()):
            assert _rel(_flat_torch(tp_), _flat_jax(jp)) < 2e-4


# ---------------------------------------------------------------------------
# whisper-medium and paligemma-3b; a q head shared by positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper-medium", "paligemma-3b"])
def test_encdec_and_prefix_lm_on_a_model_group(name):
    """1 x 2: whisper's encoder and decoder (self- and cross-attention)
    each position its 2 of 4 heads, the encoder's output replicated;
    paligemma's patches in front of the text at every position, its 4 q
    heads split over its one kv head (joined)."""
    group = _loss_and_grads_match(name, 2)
    p0 = group.shards[0]
    if name == "whisper-medium":
        assert group.dims["units/0/xattn/wq/w"] == -1
        assert group.dims["encoder/units/0/attn/wo/w"] == -2
    else:
        assert p0["units"][0]["attn"]["wq"]["w"].shape[-1] * 2 == 4 * 32
    tc = _serving_matches(name, group)
    if name == "whisper-medium":
        assert tc.shards[0]["units"][0]["xk"].shape[-2] == 2


@pytest.mark.parametrize("name,kw", [
    ("gemma3-4b", (("n_heads", 2), ("n_kv_heads", 1),
                   ("pattern", ("local", "attn_mlp")), ("tail_layers", ()))),
    ("paligemma-3b", (("n_heads", 2),))])
def test_shared_q_head_on_1x4(name, kw):
    """2 q heads over 4 positions (r = 2): positions 2h and 2h + 1 each
    run head h whole (its wq columns joined between them) over the kv
    head it reads, and multiply their half of its 32 dims by their wo
    rows. Loss, grads, prefill and decode as the reference's."""
    group = _loss_and_grads_match(name, 4, kw)
    tcfg = _model(name, kw)[1]
    pa = group.shards[0]["units"][0]["attn"]
    assert pa["wq"]["w"].shape[-1] == 16 and pa["wo"]["w"].shape[-2] == 16
    mode, local = tp._attn_locals(16, pa["wk"]["w"].shape[-1], tcfg, 4)
    assert mode == "shared" and [lc.wo_cols for lc in local] == \
        [(0, 16), (16, 32)] * 2
    _serving_matches(name, group, kw, steps=2)
