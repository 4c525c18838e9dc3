"""The port's LM training against the JAX package, on the CPU.

Both packages run the same weights (the reference initializes them; they
cross over as numpy through ``repro_torch.interop.params_from_numpy``)
and the same seeded token batches. At qwen1.5-0.5b's ``smoke()`` size (2
units, d_model 128, 4 heads of 32, d_ff 256, vocab 512), checks:

  * the config fields (new: ``remat``, ``remat_policy``, ``optimizer``)
    equal the reference's, full and smoke; an LM tree and an Adafactor
    state cross from numpy as the identity, the 0-d step included;
  * ``lm_batch`` / ``make_batch`` / the loader byte for byte;
  * the chunked flash attention's forward and its VJP against the
    reference's ``blocks.flash_attention`` under ``jax.vjp``, causal and
    bidir, with chunks that pad both q and k, 2e-5; and against the plain
    ``full_attention`` under autograd;
  * ``_chunked_ce`` over several chunks (LOSS_CHUNK patched in both
    modules) with masked labels, loss and grads 1e-5 relative;
  * the 2-unit model's per-particle loss and grads at P = 2 against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, 1e-5 relative;
  * the remat menu: the reference's ``test_checkpoint_policy_menu`` and
    ``test_remat_policy_preserves_transformer_loss_and_grads`` on the port
    (here loss and grads equal bit for bit under every policy, and a
    checkpointed stack keeps fewer bytes for the backward);
  * one fused DeepEnsemble epoch of ``adam(warmup_cosine(...))`` against
    the reference's ``functional.ensemble_step`` under ``jax.jit``, and
    a fused ``adafactor`` run against the reference's fused DeepEnsemble
    with a dead slot (capacity 3, 2 live), then the port's NEL run and a
    ``p_clone`` of the state;
  * the LM's step bodies (DeepEnsemble with Adam under warmup_cosine,
    with Adafactor, under the "dots_saveable" remat policy; SteinVGD with
    the median heuristic) run masked under the dispatch mode of
    ``tests/test_torch_train_capture.py`` that refuses a host sync;
  * ``tests/test_archs_smoke.py::test_smoke_train_step``'s semantics for
    qwen1.5-0.5b's smoke config.
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
from repro.core import functional as jfunctional
from repro.core import precision as jprec
from repro.data import DataLoader as JDataLoader
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.optim import adafactor as jadafactor
from repro.optim import adam as jadam
from repro.optim import schedules as jschedules
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.bdl import DeepEnsemble
from repro_torch.bdl.svgd import svgd_step_spec
from repro_torch.core import precision as tprec
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_map
from repro_torch.data import DataLoader
from repro_torch.data import synthetic as tsynthetic
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.runtime import eager, specs
from test_torch_nel import _bounded
from test_torch_train import _flat_jax, _flat_torch, _modules, _paths
from test_torch_train_capture import NoHostSync

P, B, S = 2, 2, 24


def _cfgs():
    return (jconfigs.get("qwen1.5-0.5b").smoke(),
            tconfigs.get("qwen1.5-0.5b").smoke())


@functools.lru_cache(maxsize=None)
def _numpy_inits(n):
    """The particles the reference's PushDistribution(seed=0) creates, in
    creation order, as numpy trees (the init jitted once)."""
    jcfg = _cfgs()[0]
    init = jax.jit(lambda k: japi.init_params(k, jcfg))
    rng, out = jax.random.PRNGKey(0), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(jax.tree.map(np.asarray, init(sub)))
    return tuple(out)


def _stacked(inits):
    return jax.tree.map(lambda *x: np.stack(x), *inits)


def _batch(cfg, seed=1, b=B, s=S):
    return jsynthetic.lm_batch(np.random.default_rng(seed), b, s,
                               cfg.vocab_size)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# configs, interop, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_lm_config_fields_match_jax(smoke):
    j, t = jconfigs.get("qwen1.5-0.5b"), tconfigs.get("qwen1.5-0.5b")
    if smoke:
        j, t = j.smoke(), t.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.remat, t.remat_policy, t.optimizer) == (False, None, "adam")
    # the config's optimizer is the one make_optimizer builds from it
    for name in ("sgd", "adam", "adafactor"):
        assert toptim.make_optimizer(t.replace(optimizer=name)).name == name


def test_lm_tree_and_adafactor_state_cross_as_identity():
    jcfg, _ = _cfgs()
    params = _numpy_inits(1)[0]
    state = jax.tree.map(np.asarray, jadafactor(0.1).init(
        jax.tree.map(jnp.asarray, params)))
    for tree in (params, state):
        got = dict(_paths(params_from_numpy(tree)))
        want = dict(_paths(tree))
        assert set(got) == set(want)
        for path, x in want.items():
            assert tuple(got[path].shape) == x.shape, path
            assert np.array_equal(got[path].numpy(), x), path
    assert params_from_numpy(state)["step"].dim() == 0
    # the port's own Adafactor state has the reference's containers
    own = toptim.adafactor(0.1).init(params_from_numpy(params))
    assert {p for p, _ in _paths(own)} == {p for p, _ in _paths(state)}


def test_lm_batches_identical():
    jcfg, tcfg = _cfgs()
    for seq in (S, 7):
        a = jsynthetic.lm_batch(np.random.default_rng(5), 3, seq, 512)
        b = tsynthetic.lm_batch(np.random.default_rng(5), 3, seq, 512)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for a, b in zip(JDataLoader(jcfg, batch_size=B, seq_len=S, num_batches=3,
                                seed=2),
                    DataLoader(tcfg, batch_size=B, seq_len=S, num_batches=3,
                               seed=2)):
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert np.array_equal(np.asarray(a[k]), b[k])
    # the audio family's frames and the vlm family's patches, drawn after
    # the tokens from the same stream
    for fam in ("audio", "vlm"):
        kw = dict(family=fam, n_frames=5, n_prefix_tokens=3)
        a = jsynthetic.make_batch(jcfg.replace(**kw),
                                  np.random.default_rng(0), 1, 4)
        b = tsynthetic.make_batch(tcfg.replace(**kw),
                                  np.random.default_rng(0), 1, 4)
        assert set(a) == set(b) == {"tokens", "labels",
                                    "frames" if fam == "audio" else "patches"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the chunked flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, Sq=13, H=4, KVH=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, B, Sq, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, B, Sq, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((P, B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("kind", ["causal", "bidir"])
@pytest.mark.parametrize("chunks", [(4, 6), (8, 4), (512, 1024)],
                         ids=["q4-k6", "q8-k4", "defaults"])
def test_flash_attention_and_vjp_match_jax(kind, chunks):
    """Forward and VJP against the reference's jnp flash attention (its
    custom VJP) per particle: 13 tokens, chunks that pad q (to 16) and k
    (to 18, 16) or none, GQA with 2 queries a kv head; 2e-5. Then the
    same against the plain ``full_attention`` under autograd."""
    qc, kc = chunks
    q, k, v, do = _qkv(7 if kind == "causal" else 8)

    def jf(q, k, v):
        return jax.vmap(lambda a, b, c: jblocks.flash_attention(
            a, b, c, kind=kind, q_chunk=qc, k_chunk=kc))(q, k, v)

    jout, vjp = jax.vjp(jf, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tout = tblocks.flash_attention(tq, tk, tv, kind=kind, q_chunk=qc,
                                   k_chunk=kc)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    assert np.abs(tout.detach().numpy() - np.asarray(jout)).max() < 2e-5
    for got, want in zip(tgrads, jgrads):
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5
    # the plain whole-sequence attention, differentiated by autograd
    pout = tblocks.full_attention(tq, tk, tv, causal=kind == "causal")
    pgrads = torch.autograd.grad(pout, (tq, tk, tv), torch.from_numpy(do))
    assert (tout - pout).abs().max() < 2e-5
    for got, want in zip(tgrads, pgrads):
        assert (got - want).abs().max() < 2e-5


def test_flash_attention_refuses_unported_kinds():
    """The "prefix" kind, once refused, against the reference's: with its
    default prefix of 0 (causal), a softcap, and a window (which the
    prefix mask ignores, in both packages), and with a prefix of 5."""
    q, k, v, _ = _qkv(1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for kw in ({"kind": "prefix"}, {"kind": "prefix", "softcap": 30.0},
               {"kind": "prefix", "window": 4},
               {"kind": "prefix", "prefix_len": 5, "q_chunk": 4}):
        got = tblocks.flash_attention(tq, tk, tv, **kw).numpy()
        want = jax.vmap(lambda a, b, c: jblocks.flash_attention(
            a, b, c, **kw))(q, k, v)
        assert np.abs(got - np.asarray(want)).max() < 2e-5, kw


# ---------------------------------------------------------------------------
# the chunked cross-entropy and the model
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_jax(monkeypatch):
    """LOSS_CHUNK 8 over 20 positions: three chunks, the last padded, and
    two masked labels; the loss and its grads in x and in the tied head
    against the reference per particle, 1e-5 relative."""
    monkeypatch.setattr(japi, "LOSS_CHUNK", 8)
    monkeypatch.setattr(tapi, "LOSS_CHUNK", 8)
    jcfg, tcfg = _cfgs()
    params = _stacked(_numpy_inits(P))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((P, B, 20, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    labels[0, 3] = labels[1, 19] = -1

    def jl(embed, x):
        return japi._chunked_ce({"embed": embed}, x, labels, jcfg)

    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(jl, argnums=(0, 1))))(
        params["embed"], x)
    emb = torch.from_numpy(params["embed"].copy()).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tloss = tapi._chunked_ce({"embed": emb}, tx, torch.from_numpy(labels),
                             tcfg)
    assert tloss.shape == (P,)
    tgrads = torch.autograd.grad(tloss.sum(), (emb, tx))
    assert _rel(tloss.detach().numpy(), np.asarray(jloss)) < 1e-5
    for got, want in zip(tgrads, jgrads):
        assert _rel(got.numpy(), np.asarray(want)) < 1e-5


def _stacked_port(inits):
    return params_from_numpy(_stacked(inits))


def test_lm_loss_and_grads_match_jax():
    """The 2-unit model at P = 2 on shared weights: per-particle loss and
    grads against ``jax.vmap(jax.value_and_grad(loss_fn))``, every leaf
    within 1e-5 of its largest entry; the loss's metrics."""
    jcfg, tcfg = _cfgs()
    params = _stacked(_numpy_inits(P))
    batch = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg)[0])))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(_stacked_port(_numpy_inits(P)),
                                               tb)
    assert tloss.shape == (P,)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-5, path
    loss, metrics = tapi.loss_fn(_stacked_port(_numpy_inits(P)), tb, tcfg)
    assert set(metrics) == {"loss"} and torch.equal(metrics["loss"], loss)
    out, aux = tapi.forward(_stacked_port(_numpy_inits(P)), tb, tcfg)
    assert out.shape == (P, B, S, tcfg.d_model) and aux == {}


def test_lm_forward_refuses_unported_layers():
    """The variants of the qwen stack that were refused before the
    encoder-decoder and prefix-LM were ported, case for case against the
    reference: a prefix-LM flag with no patches (prefix 0: causal) and a
    decoder tail layer with no params (both packages zip it away) give
    the reference's loss; decoder layers with no encoder output, and the
    audio or vlm family with no frames or patches in the batch, still
    fail in both (the reference on its missing ``ctx`` or batch key)."""
    jcfg, tcfg = _cfgs()
    batch = _batch(tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = _stacked_port(_numpy_inits(P))
    jparams = _stacked(_numpy_inits(P))
    for kw in (dict(tail_layers=("dec_attn_mlp",)), dict(prefix_lm=True)):
        jloss = jax.jit(jax.vmap(lambda p: japi.loss_fn(
            p, batch, jcfg.replace(**kw))[0]))(jparams)
        tloss, _ = tapi.loss_fn(params, tb, tcfg.replace(**kw))
        assert _rel(tloss.detach().numpy(), np.asarray(jloss)) < 1e-5, kw
    for kw, match, jkey in ((dict(pattern=("dec_attn_mlp",)), "encoder",
                             "enc_out"),
                            (dict(family="audio"), "frames", "frames"),
                            (dict(family="vlm"), "patches", "patches")):
        with pytest.raises(ValueError, match=match):
            tapi.loss_fn(params, tb, tcfg.replace(**kw))
        with pytest.raises(KeyError, match=jkey):
            japi.loss_fn(jax.tree.map(lambda a: a[0], jparams), batch,
                         jcfg.replace(**kw))


# ---------------------------------------------------------------------------
# the remat menu (tests/test_precision.py's remat tests on the port)
# ---------------------------------------------------------------------------

def test_checkpoint_policy_menu():
    for name in ("dots_saveable", "nothing_saveable",
                 "dots_with_no_batch_dims"):
        assert callable(tprec.checkpoint_policy(name))
    assert set(tprec.CHECKPOINT_POLICIES) == set(jprec.CHECKPOINT_POLICIES)
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        tprec.checkpoint_policy("everything_is_saveable")


def _saved_bytes(fn):
    """Bytes autograd keeps for the backward outside any checkpoint (a
    checkpointed region keeps its own, or recomputes them)."""
    seen = {}

    def pack(t):
        seen[id(t)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def test_remat_policy_preserves_transformer_loss_and_grads():
    """The reference's test's config (qwen, 2 units, d_model 32, 4 heads
    over 2 kv heads of 8, vocab 128, 16 tokens) at P = 2: the loss within
    1e-4 of no remat (its bar) for each policy, and on the port loss and
    grads equal bit for bit; a checkpointed stack keeps fewer bytes for
    the backward."""
    kw = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              d_ff=64, vocab_size=128, max_seq_len=32)
    jcfg = jconfigs.get("qwen1.5-0.5b").replace(**kw)
    tcfg = tconfigs.get("qwen1.5-0.5b").replace(**kw)
    init = jax.jit(lambda k: japi.init_params(k, jcfg))
    inits = [jax.tree.map(np.asarray, init(jax.random.PRNGKey(i)))
             for i in range(P)]
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                        128), np.int32)
    batch = {"tokens": torch.tensor(tok), "labels": torch.tensor(tok)}
    base = jax.jit(jax.vmap(lambda p: japi.loss_fn(
        p, {"tokens": tok, "labels": tok}, jcfg)[0]))(_stacked(inits))

    def run(cfg):
        params = tree_map(lambda x: x.requires_grad_(True),
                          params_from_numpy(_stacked(inits)))
        loss, kept = _saved_bytes(lambda: tapi.loss_fn(params, batch, cfg)[0])
        leaves = [x for _, x in _paths(params)]
        return loss.detach(), torch.autograd.grad(loss.sum(), leaves), kept

    l0, g0, kept0 = run(tcfg)
    assert _rel(l0.numpy(), np.asarray(base)) < 1e-5
    for name in ("dots_saveable", "nothing_saveable", "everything_saveable",
                 None):
        c2 = tcfg.replace(remat_policy=name, remat=name is None)
        loss, grads, kept = run(c2)
        assert float((loss - l0).abs().max()) < 1e-4, name
        assert torch.equal(loss, l0), name
        assert all(torch.equal(a, b) for a, b in zip(grads, g0)), name
        if name != "everything_saveable":
            assert kept < kept0, (name, kept, kept0)


# ---------------------------------------------------------------------------
# fused training against the reference
# ---------------------------------------------------------------------------

def _host_grads(tcfg, params, batch):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return ensemble_value_and_grad(lambda p, b: tapi.loss_fn(p, b, tcfg))(
        params, tb)[1]


def test_fused_adam_warmup_cosine_epoch_matches_jax():
    """One fused DeepEnsemble epoch (3 batches) of adam(warmup_cosine(3e-3,
    2, 3)) over 2 particles against the reference's
    ``functional.ensemble_step`` jitted, stepped over the same batches
    from the same inits. Adam's first update is about lr * sign(g): where
    |g| is near eps (1e-8) a grad difference at rounding level may move
    an entry by up to 2 lr on one side and not the other, so the params
    are held within 1e-5 where the first step's |g| > G_HOLD and the
    entries under it are counted (``_held``); the losses of every step
    within 1e-5 relative."""
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(P)
    lr = (3e-3, 2, 3)
    jopt = jadam(jschedules.warmup_cosine(*lr))
    jstep = jax.jit(jfunctional.ensemble_step(
        lambda p, b: japi.loss_fn(p, b, jcfg), jopt))
    jp = jax.tree.map(jnp.asarray, _stacked(inits))
    js = jax.vmap(jopt.init)(jp)
    batches = list(JDataLoader(jcfg, batch_size=B, seq_len=S, num_batches=3,
                               seed=0))
    g1 = _host_grads(tcfg, _stacked_port(inits), batches[0])
    jlosses = []
    for b in batches:
        jp, js, ls = jstep(jp, js, b)
        jlosses.append(np.asarray(ls))
    _, tmod = _modules(jcfg, tcfg, inits)
    algo = DeepEnsemble(tmod, backend="compiled", device="cpu")
    steps = []
    orig = tmod.loss
    tmod.loss = lambda p, b: (lambda r: (steps.append(r[0].detach()), r)[1])(
        orig(p, b))
    _, tlosses = algo.bayes_infer(
        DataLoader(tcfg, batch_size=B, seq_len=S, num_batches=3, seed=0), 1,
        num_particles=P, optimizer=toptim.adam(toptim.warmup_cosine(*lr)))
    assert len(steps) == 3
    for got, want in zip(steps, jlosses):
        assert _rel(got.numpy(), want) < 1e-5
    assert _rel(np.array(tlosses), jlosses[-1]) < 1e-5
    want = np.stack([_flat_jax(jax.tree.map(lambda x: x[i], jp))
                     for i in range(P)])
    got = np.stack([_flat_torch(p) for p in algo.p_parameters()])
    _held(got, want, g1)


# Adam's and Adafactor's first updates are sign-like where a leaf is not
# factored (Adam: every entry; Adafactor: the 1-D leaves): lr * g / |g|.
# An entry whose first grad is rounding noise (the k bias's low RoPE
# frequencies, where the bias barely moves the scores: |g| down to 2e-10
# here) takes lr with either sign on either side. A grad difference dg
# moves such an update by up to lr * dg / |g|: with dg ~1e-9 between the
# two sides and lr <= 1e-2 that is under 1e-6 where |g| > G_HOLD (1e-5),
# and those entries are held within 1e-5; the rest (0.7% of the tiny
# model's entries: rows of tokens a batch lacks) are counted and must stay
# under 2%.
G_HOLD = 1e-5


def _held(got, want, g1, tol=1e-5, loose=None):
    """``got`` within ``tol`` of ``want`` where the first |g| > G_HOLD; the
    columns of the leaf ``loose = (path, bar)`` names within ``bar``."""
    gflat = np.stack([_flat_torch(tree_map(lambda x: x[i], g1))
                      for i in range(P)])
    big = np.abs(gflat) > G_HOLD
    bars = np.full(big.shape[1], tol)
    if loose is not None:
        path, bar = loose
        marks = tree_map(lambda x: torch.zeros_like(x[0]), g1)
        node = marks
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = torch.ones_like(node[path[-1]])
        bars[_flat_torch(marks) != 0] = bar
    assert (np.abs(got - want) / bars)[big].max() < 1
    assert (~big).sum() < 0.02 * big.size


# Adafactor factors the unit-stacked k bias (n_units, d) as a matrix and
# clips each leaf by the RMS of its whole update: the entries of the
# bias along RoPE's slow frequencies (their grads rounding noise, as
# above) take O(1) updates of either sign into that RMS, so every entry
# of the leaf moves with the noise, up to lr * dg / |g| of the noisiest
# entry over the RMS. That leaf is held at K_BIAS_TOL (measured: 1.1e-5
# fused against the reference, 3.0e-5 the NEL against fused).
K_BIAS = ("units", 0, "attn", "wk", "b")
K_BIAS_TOL = 5e-5


def test_fused_adafactor_matches_jax_then_nel_and_clone():
    """DeepEnsemble with adafactor(warmup_cosine(1e-2, 2, 4)) in a store of
    capacity 3 with 2 live particles (the mask is live), 2 batches,
    against the reference's fused run: losses within 1e-5 relative, the
    params within 1e-5 where the first grad's |g| > G_HOLD (its 1-D
    leaves update as Adam's do), the k bias (``K_BIAS``) within 5e-5; the
    dead slot's Adafactor state stays
    zeros. Then the port's own NEL run (0-d steps on one-row views), held
    the same way to the fused one, and a ``p_clone`` that copies the
    state."""
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(P)
    jmod, tmod = _modules(jcfg, tcfg, inits)
    sched = (1e-2, 2, 4)
    jalgo = JDeepEnsemble(jmod, backend="compiled", capacity=3)
    _, jl = jalgo.bayes_infer(
        JDataLoader(jcfg, batch_size=B, seq_len=S, num_batches=2, seed=0),
        1, num_particles=P,
        optimizer=jadafactor(jschedules.warmup_cosine(*sched)))
    runs = {}
    for backend in ("compiled", "nel"):
        _, tmod = _modules(jcfg, tcfg, inits)
        algo = DeepEnsemble(tmod, backend=backend, capacity=3, device="cpu")
        _, tl = _bounded(
            algo.bayes_infer,
            DataLoader(tcfg, batch_size=B, seq_len=S, num_batches=2, seed=0),
            1, num_particles=P,
            optimizer=toptim.adafactor(toptim.warmup_cosine(*sched)))
        runs[backend] = (algo, tl)
    algo, tl = runs["compiled"]
    assert _rel(np.array(tl), np.array(jl)) < 1e-5
    g1 = _host_grads(tcfg, _stacked_port(inits), next(iter(JDataLoader(
        jcfg, batch_size=B, seq_len=S, num_batches=2, seed=0))))
    got = np.stack([_flat_torch(p) for p in algo.p_parameters()])
    _held(got, np.stack([_flat_jax(p) for p in jalgo.p_parameters()]), g1,
          loose=(K_BIAS, K_BIAS_TOL))
    opt_state = algo.store.stacked("opt_state")
    assert opt_state["step"].tolist()[:P] == [2] * P
    assert not opt_state["step"][P:].any()       # dead slots: never stepped
    for _, leaf in _paths(opt_state["v"]):
        assert leaf.dtype == torch.float32 and not leaf[P:].any()
    nel, nl = runs["nel"]
    assert _rel(np.array(nl), np.array(tl)) < 1e-5
    _held(np.stack([_flat_torch(p) for p in nel.p_parameters()]), got, g1,
          loose=(K_BIAS, K_BIAS_TOL))
    nel.cleanup()
    pd = algo.push_dist
    src = pd.particle_ids()[0]
    new = pd.p_clone(src)
    a = dict(_paths(pd.store.read("opt_state", src)))
    b = dict(_paths(pd.store.read("opt_state", new)))
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    algo.cleanup()


def test_smoke_train_step_qwen():
    """``tests/test_archs_smoke.py::test_smoke_train_step`` on the port for
    qwen1.5-0.5b's smoke config: the loss (one value a particle) and the
    grads finite, and finite again after one Adam update."""
    _, sc = _cfgs()
    params = tree_map(lambda x: x[None], tapi.init_params(
        torch.Generator().manual_seed(0), sc))
    batch = {"tokens": torch.ones((2, 32), dtype=torch.int32),
             "labels": torch.ones((2, 32), dtype=torch.int32)}
    opt = toptim.adam(1e-3)
    opt_state = opt.init(tree_map(lambda x: x[0], params))
    opt_state = tree_map(lambda x: x[None], opt_state)
    loss, metrics = tapi.loss_fn(params, batch, sc)
    assert loss.shape == (1,) and bool(torch.isfinite(loss).all())
    _, grads = ensemble_value_and_grad(lambda p, b: tapi.loss_fn(p, b, sc))(
        params, batch)
    gn = sum(float(g.square().sum()) for _, g in _paths(grads))
    assert np.isfinite(gn)
    new_params, _ = opt.update(params, grads, opt_state)
    l2, _ = tapi.loss_fn(new_params, batch, sc)
    assert bool(torch.isfinite(l2).all())


@pytest.mark.parametrize("body", ["adam-warmup", "adafactor", "remat-dots",
                                  "svgd-median"])
def test_lm_step_bodies_never_sync_the_host(body):
    """Each LM step body over 3 slots, one dead, under a dispatch mode
    that raises on ``nonzero``, ``_local_scalar_dense`` and
    ``is_nonzero``: a captured step reads the schedule, the loss chunks'
    counts and the attention's masks on the device."""
    _, tcfg = _cfgs()
    if body == "remat-dots":
        tcfg = tcfg.replace(remat_policy="dots_saveable")
    loss = lambda p, b: tapi.loss_fn(p, b, tcfg)    # noqa: E731
    inits = _numpy_inits(3)
    params = _stacked_port(inits)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    mask = torch.tensor([1.0, 0.0, 1.0])
    if body == "svgd-median":
        spec = svgd_step_spec(loss, lr=1e-3, lengthscale=0.0)
        args = (params, batch, mask)
    else:
        opt = (toptim.adafactor(toptim.warmup_cosine(1e-2, 2, 8))
               if body == "adafactor"
               else toptim.adam(toptim.warmup_cosine(3e-3, 2, 8)))
        state = tree_map(lambda *x: torch.stack(x), *[
            opt.init(params_from_numpy(i)) for i in inits])
        spec = specs.ensemble_step(loss, opt)
        args = (params, state, batch, mask)
    prog = eager(spec, args)
    with NoHostSync():
        out = prog(*args)
    assert all(bool(torch.isfinite(x).all()) for _, x in _paths(out))
