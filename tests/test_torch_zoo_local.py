"""gemma3's sliding-window layers and the logit softcap on the port,
against the JAX package, on the CPU.

Both packages run the same weights (the reference initializes them; they
cross over as numpy). At gemma3-4b's ``smoke()`` size (1 unit of 5
``local`` + 1 global layer and 1 tail ``local`` layer, window 16, d_model
128, 4 heads of 32 over 4 kv heads, vocab 512), checks:

  * the chunked flash attention's forward and its grads against the
    reference's ``blocks.flash_attention`` on ``tests/test_blocks.py``'s
    grid (causal, sliding, bidir; chunks 16 / 8), and with a softcap (the
    reference differentiates the capped forward itself);
  * the model's loss and grads at P = 2 against the reference's, 1e-5;
  * the reference's two ring tests (``tests/test_archs_smoke.py``): a
    decode from an empty cache past the window, and a prefill longer than
    the window then a decode, each against a full forward;
  * the ring's layout after prefill against the reference's (every slot's
    position, K and V), and the dense-cache prefill and decode logits
    against the reference's within 1e-4 with the greedy tokens equal;
  * ``PredictiveEngine(stateful=True)`` over ring caches against the
    reference's engine;
  * softcap in dense decode takes the plain form (no dense-decode kernel
    launch is asked for: the plain version is called directly), and the
    paged path refuses ``local`` layers and softcap, as the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.serve import PredictiveEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.serve import PredictiveEngine
from test_torch_train import _paths

P = 2


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cfgs(**kw):
    return (jconfigs.get("gemma3-4b").smoke().replace(**kw),
            tconfigs.get("gemma3-4b").smoke().replace(**kw))


def _stacked_jax(jcfg, n=P):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda k: japi.init_params(k, jcfg)))(keys))


# ---------------------------------------------------------------------------
# the flash attention: sliding window and softcap
# ---------------------------------------------------------------------------

# tests/test_blocks.py's grid (the prefix case stays with item 11), and
# softcap cases
CASES = [
    (2, 37, 4, 2, 8, "causal", 0, 0.0),
    (1, 64, 4, 1, 16, "sliding", 7, 0.0),
    (1, 33, 4, 4, 8, "bidir", 0, 0.0),
    (2, 50, 4, 2, 8, "sliding", 16, 0.0),
    (1, 40, 4, 2, 8, "causal", 0, 5.0),
    (2, 45, 2, 1, 16, "sliding", 9, 3.0),
]


@pytest.mark.parametrize("B,S,H,KVH,hd,kind,w,cap", CASES)
def test_flash_sliding_and_softcap_match_jax(B, S, H, KVH, hd, kind, w, cap):
    """Forward within 1e-5 and grads of a random cotangent within 1e-5 of
    their largest entries, per particle, against the reference's flash
    attention at q_chunk 16, k_chunk 8."""
    rng = np.random.default_rng(S + w)
    q = rng.standard_normal((P, B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, B, S, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((P, B, S, H, hd)).astype(np.float32)

    def jf(q, k, v):
        return jax.vmap(lambda a, b, c: jblocks.flash_attention(
            a, b, c, kind=kind, window=w, softcap=cap, q_chunk=16,
            k_chunk=8))(q, k, v)

    jout, vjp = jax.vjp(jf, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tout = tblocks.flash_attention(tq, tk, tv, kind=kind, window=w,
                                   softcap=cap, q_chunk=16, k_chunk=8)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    assert _rel(tout.detach().numpy(), np.asarray(jout)) < 1e-5
    for got, want in zip(tgrads, jgrads):
        assert _rel(got.numpy(), np.asarray(want)) < 1e-5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_gemma_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    assert tcfg.sliding_window == 16
    params = _stacked_jax(jcfg)
    batch = jsynthetic.lm_batch(np.random.default_rng(1), 2, 40,
                                jcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg)[0])))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(params_from_numpy(params), tb)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-5, path


def test_softcap_loss_and_grads_match_jax():
    """A softcap of 5 on the scores of every layer (the reference's
    forward-only capped flash attention, differentiated by autograd)."""
    jcfg, tcfg = _cfgs(logit_softcap=5.0)
    params = _stacked_jax(jcfg)
    batch = jsynthetic.lm_batch(np.random.default_rng(2), 2, 24,
                                jcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg)[0])))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(params_from_numpy(params), tb)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    for path, g in _paths(tgrads):
        assert _rel(g.numpy(), want[path]) < 1e-5, path


def _full_logits(params, toks, cfg):
    out, _ = tapi.forward(params, {"tokens": toks, "labels": toks}, cfg)
    return tapi._lm_logits(params, out[:, :, -1:], cfg)[:, :, 0]


def test_gemma_sliding_window_decode_ring_cache():
    """``tests/test_archs_smoke.py::test_gemma_sliding_window_decode_ring_
    cache`` on the port: 24 tokens decoded one by one from an empty
    cache (the 16-slot rings wrap) against a full forward, 1e-2 there;
    here within 1e-4."""
    _, sc = _cfgs()
    params = tree_map(lambda a: a[None], tapi.init_params(
        torch.Generator().manual_seed(0), sc))
    S = 24
    toks = torch.randint(0, sc.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(1))
    cache = tapi.init_cache(sc, 1, S + 1, particles=1, device="cpu")
    assert cache["units"][0]["k"].shape[-3] == 16       # a local ring
    assert cache["units"][5]["k"].shape[-3] == S + 1    # the global layer
    for t in range(S):
        logits, cache = tapi.decode_step(params, toks[:, t], cache, t, sc)
    ref = _full_logits(params, toks, sc)
    assert (logits - ref).abs().max().item() < 1e-4


def test_gemma_prefill_then_decode_ring_roll():
    """``tests/test_archs_smoke.py::test_gemma_prefill_then_decode_ring_
    roll`` on the port: prefill of 24 tokens (> window 16) with 32 slots
    of headroom, then one decode step, against a full forward."""
    _, sc = _cfgs()
    params = tree_map(lambda a: a[None], tapi.init_params(
        torch.Generator().manual_seed(0), sc))
    S = 24
    toks = torch.randint(0, sc.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(2))
    logits_pre, caches = tapi.prefill(params, {"tokens": toks}, sc,
                                      max_len=32)
    nxt = logits_pre[0].argmax(-1).to(torch.int32)
    logits_dec, _ = tapi.decode_step(params, nxt, caches, S, sc)
    toks2 = torch.cat([toks, nxt[:, None]], 1)
    ref = _full_logits(params, toks2, sc)
    assert (logits_dec - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("L", [11, 16, 29, 40])
def test_ring_layout_and_dense_decode_match_jax(L):
    """Prefill of L tokens (shorter than, equal to and past the window of
    16, past it by more than a ring) with 6 slots of headroom, then 5
    greedy decode steps: every ring's slot positions equal the
    reference's (slot s holds the position p with p % 16 == s), its K and
    V within 1e-4; logits within 1e-4 and the greedy tokens equal."""
    jcfg, tcfg = _cfgs()
    params = _stacked_jax(jcfg)
    tparams = params_from_numpy(params)
    steps = 5
    prompts = np.random.default_rng(L).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    jl, jc = jax.jit(jax.vmap(lambda p: japi.prefill(
        p, {"tokens": jnp.asarray(prompts)}, jcfg, max_len=L + steps + 1)))(
        jparams)
    jdecode = jax.jit(jax.vmap(lambda p, t, c, pos: japi.decode_step(
        p, t, c, pos, jcfg, decode_kernel=True), in_axes=(0, None, 0, None)))
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L + steps + 1)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4

    def check_caches():
        for where in ("units", "tail"):
            for j, (jcache, tcache) in enumerate(zip(jc[where],
                                                     tc[where])):
                jpos = np.asarray(jcache["pos"])[0]
                tpos = tcache["pos"].numpy()
                C = tpos.shape[-1]
                assert np.array_equal(tpos, jpos[..., :C]), (where, j)
                assert (jpos[..., C:] == -1).all()
                live = tpos >= 0
                if C == 16:
                    assert (tpos[live] % 16 == np.nonzero(live)[-1]).all()
                jk = np.asarray(jcache["k"])[..., :C, :, :]
                assert np.abs(tcache["k"].numpy() - jk).max() < 1e-4
                jv = np.asarray(jcache["v"])[..., :C, :, :]
                assert np.abs(tcache["v"].numpy() - jv).max() < 1e-4

    check_caches()
    for step in range(steps):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().mean(0).argmax(-1))
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc, jnp.int32(L + step))
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  L + step, tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, step
    check_caches()


def test_softcap_dense_decode_takes_the_plain_form(monkeypatch):
    """With a softcap the dense decode calls the plain decode attention
    with the cap (the reference's jnp form; its kernel has no softcap),
    and never the kernel's entry; the logits match the reference's."""
    jcfg, tcfg = _cfgs(logit_softcap=5.0)
    params = _stacked_jax(jcfg)
    tparams = params_from_numpy(params)
    calls = []
    monkeypatch.setattr(tops, "decode_attention",
                        lambda *a, **k: calls.append(1))
    L = 20
    prompts = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    jl, jc = jax.jit(jax.vmap(lambda p: japi.prefill(
        p, {"tokens": jnp.asarray(prompts)}, jcfg, max_len=L + 2)))(
        jax.tree.map(jnp.asarray, params))
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L + 2)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
    jl, _ = jax.jit(jax.vmap(lambda p, c: japi.decode_step(
        p, jnp.asarray(tok), c, jnp.int32(L), jcfg)))(
        jax.tree.map(jnp.asarray, params), jc)
    tl, _ = tapi.decode_step(tparams, torch.from_numpy(tok), tc, L, tcfg)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    assert calls == []
    q = torch.randn(1, 2, 4, 8)
    kc = torch.randn(1, 2, 5, 2, 8)
    pos = torch.tensor([[0, 1, 2, -1, -1], [0, 1, 2, 3, 4]],
                       dtype=torch.int32)
    capped = tref.decode_attention(q, kc, kc, pos, softcap=0.5)
    assert (capped - tref.decode_attention(q, kc, kc, pos)).abs().max() > 1e-3


def test_paged_path_refuses_local_layers_and_softcap():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="paged decode supports"):
        tapi.paged_cache_init(tcfg, num_pages=4, page_size=4, device="cpu")
    _, qcfg = (None, tconfigs.get("qwen1.5-0.5b").smoke().replace(
        logit_softcap=5.0))
    params = tree_map(lambda a: a[None], tapi.init_params(
        torch.Generator().manual_seed(0), qcfg))
    pages = tree_map(lambda a: a[None], tapi.paged_cache_init(
        qcfg, num_pages=4, page_size=4, device="cpu"))
    bt = torch.arange(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="softcap"):
        tapi.prefill_paged(params, torch.ones((1, 4), dtype=torch.int32),
                           pages, bt, 3, qcfg)
    with pytest.raises(NotImplementedError, match="softcap"):
        tapi.decode_step_paged(params, torch.ones(1, dtype=torch.int32),
                               pages, bt[None], torch.tensor(
                                   [3], dtype=torch.int32), qcfg)


def _lm_forward(cfg):
    def fwd(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], cfg)
    return fwd


def test_gemma_stateful_engine_matches_jax_engine():
    """``PredictiveEngine(stateful=True)`` over ring caches: prompts of 20
    tokens (past the window), 6 greedy steps, the heads within 1e-4 of
    the reference's engine."""
    jcfg, tcfg = _cfgs()
    L, max_new = 20, 6
    prompts = np.random.default_rng(4).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg, decode_kernel=True),
            store=jpd.store, stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + max_new)[1])
        stacked = jax.tree.map(np.asarray, jpd.store.stacked("params"))
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(max_new):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    tparams = params_from_numpy(stacked)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(P):
        pd.p_create(params=tree_map(lambda a: a[p], tparams))
    eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store, stateful=True)
    toks = torch.from_numpy(prompts)
    state = eng.init_state(lambda p: tapi.prefill(
        p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + max_new)[1])
    tok = toks[:, -1]
    for step in range(max_new):
        heads, state = eng.step(state, {"token": tok, "cur_pos": L - 1 + step})
        for k, want in jheads[step].items():
            assert np.abs(heads[k].numpy() - want).max() < 1e-4, (step, k)
        tok = heads["mean"].argmax(-1).to(torch.int32)
