"""The port's recurrent LMs against the JAX package, on the CPU:
zamba2-1.2b (family "hybrid": Mamba2 blocks and one ``shared_attn``
block whose single parameter copy serves every occurrence) and rwkv6-7b
(family "ssm").

Both packages run the same weights (the reference initializes them; they
cross over as numpy). At each arch's ``smoke()`` size (zamba2: 1 unit of
5 ``mamba`` + 1 ``shared_attn`` and 1 tail ``mamba``, d_model 128, 8
ssm heads of 32, d_state 16; rwkv6: 2 ``rwkv`` layers, d_model 128, 4
heads of 32) with P = 2 particles, checks:

  * the configs equal the reference's, full and smoke, and the port's
    own init builds the reference's tree (``params["shared"]``, ``{}``
    at the shared position of ``units``);
  * ``loss_fn`` and every leaf's grad at 1e-5 relative, ``["shared"]``'s
    summed over its occurrences;
  * ``prefill`` of a 70-token prompt (mamba's chunk 64 and rwkv's 32 both
    pad) and 4 ``decode_step`` s: logits and every layer's state within
    1e-4, the greedy tokens equal; 8 greedy steps token-exact;
  * a ``save_store`` / ``restore_store`` round trip that the reference
    reads, and the reference's files read by the port;
  * the model axis runs these stacks (ROADMAP.md queue 1, item 25: the
    group equals the one-device port), and a precision preset other
    than fp32 is refused (item 21).

The stateful engine on these stacks is
``tests/test_torch_recurrent_serve.py``'s; the fused training steps, the
NEL and a data mesh ``tests/test_torch_recurrent_train.py``'s; MultiSWAG
``tests/test_torch_recurrent_swag.py``'s.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import Group, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from test_torch_train import _paths

P = 2
ARCHS = ("zamba2-1.2b", "rwkv6-7b")



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's many small ops: on a shared CPU
    a pool of threads waits on its slowest member (steps of 0.1 s took up
    to 10 s with 8 threads). Values do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cfgs(name):
    return jconfigs.get(name).smoke(), tconfigs.get(name).smoke()


@functools.lru_cache(maxsize=None)
def _inits(name, n=P):
    """The particles the reference's PushDistribution(seed=0) creates, as
    numpy trees (the init jitted once)."""
    jcfg = _cfgs(name)[0]
    init = jax.jit(lambda k: japi.init_params(k, jcfg))
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(jax.tree.map(np.asarray, init(sub)))
    return tuple(out)


def _stacked(name):
    return jax.tree.map(lambda *x: np.stack(x), *_inits(name))


def _jax_module(jcfg):
    return JModule(init=lambda r: japi.init_params(r, jcfg),
                   loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                   forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                   cfg=jcfg)


def _port_pd(tcfg, stacked):
    tparams = params_from_numpy(stacked)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(P):
        pd.p_create(params=tree_map(lambda a: a[p], tparams))
    return pd


# ---------------------------------------------------------------------------
# configs and the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_match_jax(name, smoke):
    j, t = jconfigs.get(name), tconfigs.get(name)
    if smoke:
        j, t = j.smoke(), t.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.hd, t.n_layers) == (j.hd, j.n_layers)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    """The smoke model at P = 2: the loss and every leaf's grad within
    1e-5 relative (zamba2's ``["shared"]`` grads sum over its
    occurrences); the port's own init builds the reference's tree."""
    jcfg, tcfg = _cfgs(name)
    params = _stacked(name)
    batch = jsynthetic.lm_batch(np.random.default_rng(1), 2, 40,
                                jcfg.vocab_size)
    (jloss, jm), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg), has_aux=True)))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(params_from_numpy(params), tb)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-5, path
    assert any(p[0] == "shared" for p in want) == (name == "zamba2-1.2b")
    own = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {p: tuple(t.shape) for p, t in _paths(own)} == \
        {p: tuple(x.shape[1:]) for p, x in want.items()}
    assert sorted(own) == sorted(_inits(name)[0])
    if "shared" in own:
        assert own["units"][tcfg.pattern.index("shared_attn")] == {}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

L_PROMPT = 70        # mamba's 64-token chunk and rwkv's 32 both pad
NEW = 8


def _prompts(jcfg, seed):
    return np.random.default_rng(seed).integers(
        1, jcfg.vocab_size, (3, L_PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_serving(name):
    """The reference's prefill (3 prompts of L_PROMPT tokens, NEW slots of
    headroom) and decode step, vmapped over the particles and jitted once
    per arch."""
    jcfg = _cfgs(name)[0]
    prefill = jax.jit(jax.vmap(lambda p, t: japi.prefill(
        p, {"tokens": t}, jcfg, max_len=L_PROMPT + NEW),
        in_axes=(0, None)))
    decode = jax.jit(jax.vmap(lambda p, t, c, pos: japi.decode_step(
        p, t, c, pos, jcfg), in_axes=(0, None, 0, None)))
    return prefill, decode


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name):
    """Dense prefill of a 70-token prompt, then 4 greedy decode steps:
    logits within 1e-4 relative, the greedy tokens equal, every layer's
    state (and the shared block's k/v caches) within 1e-4."""
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(name)
    tparams = params_from_numpy(stacked)
    prompts = _prompts(jcfg, 6)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jprefill, jdecode = _jax_serving(name)
    jl, jc = jprefill(jparams, jnp.asarray(prompts))
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L_PROMPT + NEW)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    for step in range(4):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().mean(0).argmax(-1))
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc,
                         jnp.int32(L_PROMPT + step))
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  L_PROMPT + step, tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, step
    want = dict(_paths(jax.tree.map(np.asarray, jc)))
    got = dict(_paths(tc))
    assert set(got) == set(want)
    for path, x in want.items():
        g = got[path].numpy()
        if path[-1] == "pos":          # shared by the particles in the port
            assert np.array_equal(g, x[0]), path
        else:
            assert g.shape == x.shape, path
            assert np.abs(g - x).max() < 1e-4 * max(np.abs(x).max(), 1), path


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_decode_is_token_exact(name):
    """NEW greedy BMA steps (the argmax of the particles' mean
    probabilities) after a prefill: the reference's tokens."""
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(name)
    prompts = _prompts(jcfg, 11)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jprefill, jdecode = _jax_serving(name)
    jl, jc = jprefill(jparams, jnp.asarray(prompts))
    tparams = params_from_numpy(stacked)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L_PROMPT + NEW)
    jt, tt = [], []
    for step in range(NEW):
        jtok = jax.nn.softmax(jl, -1).mean(0).argmax(-1).astype(jnp.int32)
        ttok = torch.softmax(tl, -1).mean(0).argmax(-1).to(torch.int32)
        jt.append(np.asarray(jtok))
        tt.append(ttok.numpy())
        jl, jc = jdecode(jparams, jtok, jc, jnp.int32(L_PROMPT + step))
        tl, tc = tapi.decode_step(tparams, ttok, tc, L_PROMPT + step, tcfg)
    assert np.array_equal(np.stack(tt), np.stack(jt))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_store_checkpoints_both_ways(name, tmp_path):
    """A smoke store of 2 particles saved by each package and restored by
    the other: equal bytes leaf for leaf, the same arrays under the same
    names in the same (``jax.tree``) order, and zamba2's empty shared
    position kept as ``{}``."""
    jcfg, tcfg = _cfgs(name)
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        want = jax.tree.map(np.asarray, jpd.store.stacked("params"))
        jfile = jckpt.save_store(str(tmp_path / "ref"), 3, jpd.store)
    pd = _port_pd(tcfg, want)
    _, restored = tckpt.restore_store(str(tmp_path / "ref"), device="cpu")
    got = restored.stacked("params")
    flat = dict(_paths(want))
    assert set(dict(_paths(got))) == set(flat)
    for path, x in _paths(got):
        assert np.array_equal(x.numpy(), flat[path]), path
    if "shared" in want:
        assert got["units"][tcfg.pattern.index("shared_attn")] == {}
    tfile = tckpt.save_store(str(tmp_path / "port"), 3, pd.store)
    _, back = jckpt.restore_store(str(tmp_path / "port"))
    back = back.stacked("params")
    assert jax.tree.structure(back) == jax.tree.structure(want)
    back = dict(_paths(jax.tree.map(np.asarray, back)))
    for path, x in flat.items():
        assert np.array_equal(back[path], x), path
    jz, tz = np.load(jfile), np.load(tfile)
    assert jz.files == tz.files
    for n in jz.files:
        if n != "__store_manifest__":
            assert np.array_equal(jz[n], tz[n]), n
    jm, tm = (json.loads(str(z["__store_manifest__"])) for z in (jz, tz))
    assert jm["keys"] == tm["keys"]
    pd.cleanup()


# ---------------------------------------------------------------------------
# the model axis, and what these stacks do not run
# ---------------------------------------------------------------------------

def model_group(tparams, m):
    """A model group of ``m`` logical CPU positions of a stacked port tree,
    each leaf split as the store splits it (``rules.model_dims``)."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.sharding import rules
    dims = rules.model_dims(tparams, m, lead=1)
    paths = [p for p, _ in rules.named_leaves(tparams)]
    leaves, unflatten = tree_flatten(tparams)
    return Group([unflatten([rules.split_leaf(x, dims[p], m, j).contiguous()
                             for p, x in zip(paths, leaves)])
                  for j in range(m)], dims, ["cpu"] * m)


@pytest.mark.parametrize("name", ARCHS)
def test_model_axis_refuses_recurrent_stacks(name):
    """The model axis no longer refuses these stacks (ROADMAP.md queue 1,
    item 25, done): on a group of two CPU positions the loss, a prefill
    and a decode step equal the one-device port's within 1e-5 relative,
    each position's state holding half the heads.
    ``tests/test_torch_placement2d_families.py`` holds the group to the
    reference."""
    _, tcfg = _cfgs(name)
    params = params_from_numpy(_stacked(name))
    group = model_group(params, 2)
    toks = torch.ones((1, 4), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    one = tapi.loss_fn(params, batch, tcfg)[0]
    assert _rel(tapi.loss_fn(group, batch, tcfg)[0].numpy(),
                one.numpy()) < 1e-5
    lp, cp = tapi.prefill(params, {"tokens": toks}, tcfg, max_len=6)
    lg, cg = tapi.prefill(group, {"tokens": toks}, tcfg, max_len=6)
    assert _rel(lg.numpy(), lp.numpy()) < 1e-5
    key = "ssm" if tcfg.pattern[0] == "mamba" else "state"
    assert cg.shards[0]["units"][0][key].shape[-3] * 2 == \
        cp["units"][0][key].shape[-3]
    lp = tapi.decode_step(params, toks[:, 0], cp, 4, tcfg)[0]
    lg = tapi.decode_step(group, toks[:, 0], cg, 4, tcfg)[0]
    assert _rel(lg.numpy(), lp.numpy()) < 1e-5


@pytest.mark.parametrize("name", ARCHS)
def test_precision_presets_are_refused(name):
    """Only fp32 is held on these stacks: a store under another preset
    raises NotImplementedError naming item 21."""
    _, tcfg = _cfgs(name)
    for prec in ("mixed", "bf16"):
        with pytest.raises(NotImplementedError, match="item 21"):
            PushDistribution(ParticleModule(init=None, cfg=tcfg),
                             device="cpu", precision=prec)
        with pytest.raises(NotImplementedError, match="item 21"):
            PushDistribution(ParticleModule(
                init=None, cfg=tcfg.replace(precision=prec)), device="cpu")
