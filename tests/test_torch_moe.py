"""The port's MoE models against the JAX package, on the CPU.

Both packages run the same weights (the reference initializes them; they
cross over as numpy through ``repro_torch.interop.params_from_numpy``).
Checks:

  * the four decoder-only zoo configs (deepseek-moe-16b,
    qwen3-moe-235b-a22b, gemma3-4b, llama3-405b) equal the reference's,
    full and smoke, and build through ``configs.get``;
  * ``moe_apply`` per particle against the reference's: the top-k
    experts, each assignment's slot and ``dropped_frac`` exactly equal
    (with drops at capacity factor 1.0, and with a shared expert), y
    within 1e-5; against ``moe_ref`` within 1e-4; the uniform router's
    picks (all-equal probabilities: the lower expert first) and its
    load-balance loss; the grads against ``jax.grad`` within 1e-5;
  * deepseek's and qwen3-moe's smoke models: ``loss_fn`` with the aux
    losses and its grads at 1e-5; paged prefill, decode and the verify
    window, and dense-cache prefill and decode: logits within 1e-4, the
    greedy tokens equal;
  * ``serve_decode``, plain and speculative, token for token against the
    reference's plain scheduler; ``PredictiveEngine(stateful=True)``
    against the reference's engine;
  * a fused DeepEnsemble epoch against the reference's jitted
    ``ensemble_step`` (1e-4), and the MoE step bodies under the dispatch
    mode that refuses a host sync;
  * a deepseek smoke store through ``save_store`` / ``restore_store`` in
    both directions with the reference's files.

Where routing could differ from the reference's (two probabilities of a
token within rounding of each other), a test prints the smallest gap
between a token's k-th and (k+1)-th probabilities.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JConfig
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.core import functional as jfunctional
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JEngine
from repro.serve import serve_decode as jserve_decode
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.bdl import DeepEnsemble
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_map
from repro_torch.data import DataLoader
from repro_torch.data import synthetic as tsynthetic
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.runtime import eager, specs
from repro_torch.serve import PredictiveEngine, SpecConfig, serve_decode
from test_torch_train import _flat_jax, _flat_torch, _modules, _paths
from test_torch_train_capture import NoHostSync

P = 2
ZOO = ("deepseek-moe-16b", "qwen3-moe-235b-a22b", "gemma3-4b", "llama3-405b")
MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_fields_match_jax(name, smoke):
    j, t = jconfigs.get(name), tconfigs.get(name)
    if smoke:
        j, t = j.smoke(), t.smoke()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.hd, t.n_layers) == (j.hd, j.n_layers)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_make_batch_matches_jax(name):
    """``make_batch`` gives the moe family the LM batch, byte for byte the
    reference's."""
    j, t = jconfigs.get(name).smoke(), tconfigs.get(name).smoke()
    a = jsynthetic.make_batch(j, np.random.default_rng(3), 2, 9)
    b = tsynthetic.make_batch(t, np.random.default_rng(3), 2, 9)
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert np.array_equal(np.asarray(a[k]), b[k])


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_cfgs(**kw):
    base = dict(name="t", family="moe", d_model=16, vocab_size=10,
                n_experts=4, top_k=2, moe_d_ff=32, capacity_factor=8.0)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _moe_params(jcfg, n=P, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.tree.map(np.asarray, jax.vmap(
        lambda k: jmoe.moe_init(k, jcfg))(keys))


def _ref_routing(p, x, cfg):
    """The reference's routing of one particle, step for step as its
    ``moe_apply`` takes it: (top_e, slot in assignment order, kept)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = jmoe.capacity(cfg, T)
    logits = x.reshape(T, D).astype(jnp.float32) @ p["router"]["w"]
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.bincount(se, length=E)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos_in_e = jnp.arange(T * k) - starts[se]
    keep = pos_in_e < C
    slot = jnp.where(keep, se * C + pos_in_e, E * C)
    slot_flat = jnp.zeros_like(slot).at[order].set(slot)
    return np.asarray(top_e), np.asarray(slot_flat), np.asarray(probs)


def _slots(r, cfg):
    """Each assignment's slot in flat order (P, T * k) from the port's
    ``route``: ``e * C + pos`` when kept, the drop bin ``E * C``
    otherwise (the reference's ``slot``)."""
    C, E = r["C"], cfg.n_experts
    keep = r["pos"] < C
    e = r["top_e"].reshape(keep.shape)
    return torch.where(keep, e * C + r["pos"], E * C)


def _tie_gap(probs, k):
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    s = -np.sort(-probs, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if s.shape[-1] > k \
        else float("inf")


@pytest.mark.parametrize("case", ["drops", "shared", "no-drops"])
def test_moe_apply_matches_jax(case):
    """Per particle: top-k experts, slots and dropped_frac exactly the
    reference's; y within 1e-5 of its largest entry; lb and z losses
    within 1e-5."""
    kw = {"drops": dict(capacity_factor=1.0),
          "shared": dict(capacity_factor=1.0, n_shared_experts=1,
                         shared_d_ff=32),
          "no-drops": {}}[case]
    jcfg, tcfg = _moe_cfgs(**kw)
    params = _moe_params(jcfg)
    S = 256 if case != "no-drops" else 8
    x = np.random.default_rng(2).standard_normal(
        (P, 2, S, 16)).astype(np.float32)
    tp = params_from_numpy(params)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    r = tmoe.route(tp, torch.from_numpy(x).reshape(P, -1, 16), tcfg)
    tslot = _slots(r, tcfg).numpy()
    dropped = []
    for i in range(P):
        pi = jax.tree.map(lambda a: a[i], params)
        jy, jaux = jmoe.moe_apply(pi, jnp.asarray(x[i]), jcfg)
        top_e, slot, probs = _ref_routing(pi, jnp.asarray(x[i]), jcfg)
        gap = _tie_gap(probs, jcfg.top_k)
        if not np.array_equal(r["top_e"][i].numpy(), top_e):
            print(f"particle {i}: routing differs; smallest top-k gap "
                  f"{gap:.3e}")
        assert np.array_equal(r["top_e"][i].numpy(), top_e), gap
        assert np.array_equal(tslot[i], slot)
        assert float(taux["dropped_frac"][i]) == float(jaux["dropped_frac"])
        dropped.append(float(jaux["dropped_frac"]))
        assert _rel(ty[i].numpy(), np.asarray(jy)) < 1e-5
        for key in ("lb_loss", "z_loss"):
            assert abs(float(taux[key][i]) - float(jaux[key])) <= \
                1e-5 * max(1.0, abs(float(jaux[key])))
    if case == "no-drops":
        assert max(dropped) == 0.0
    else:
        assert 0.0 < max(dropped) < 0.5


def test_moe_matches_dense_oracle():
    """``tests/test_moe_ssm.py::test_moe_matches_dense_oracle`` on the port
    (shared expert, no drops): moe_apply within 1e-4 of moe_ref, which is
    within 1e-5 of the reference's moe_ref."""
    jcfg, tcfg = _moe_cfgs(n_shared_experts=1, shared_d_ff=32)
    params = _moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (P, 2, 8, 16)).astype(np.float32)
    tp, tx = params_from_numpy(params), torch.from_numpy(x)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    yr = tmoe.moe_ref(tp, tx, tcfg)
    assert (y - yr).abs().max().item() < 1e-4
    assert aux["dropped_frac"].abs().max().item() == 0.0
    for i in range(P):
        jr = jmoe.moe_ref(jax.tree.map(lambda a: a[i], params),
                          jnp.asarray(x[i]), jcfg)
        assert _rel(yr[i].numpy(), np.asarray(jr)) < 1e-5


def test_moe_uniform_router_picks_the_reference_experts():
    """All-equal probabilities: the reference's ``lax.top_k`` takes the
    lower experts first and so does the port's stable sort; lb_loss at
    its minimum of 1 on both."""
    jcfg, tcfg = _moe_cfgs()
    params = _moe_params(jcfg)
    params["router"]["w"] = np.zeros_like(params["router"]["w"])
    x = np.random.default_rng(3).standard_normal(
        (P, 4, 64, 16)).astype(np.float32)
    tp = params_from_numpy(params)
    r = tmoe.route(tp, torch.from_numpy(x).reshape(P, -1, 16), tcfg)
    _, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    for i in range(P):
        pi = jax.tree.map(lambda a: a[i], params)
        top_e, slot, _ = _ref_routing(pi, jnp.asarray(x[i]), jcfg)
        assert np.array_equal(r["top_e"][i].numpy(), top_e)
        assert (top_e == np.arange(2)).all()
        assert np.array_equal(_slots(r, tcfg)[i].numpy(), slot)
        _, jaux = jmoe.moe_apply(pi, jnp.asarray(x[i]), jcfg)
        assert abs(float(taux["lb_loss"][i]) - float(jaux["lb_loss"])) < 1e-6
    assert (taux["lb_loss"] - 1.0).abs().max().item() < 0.15


def test_moe_grads_match_jax():
    """Grads of sum(y) + lb + z in every leaf (router, experts, shared) and
    in x against ``jax.grad`` of the reference per particle, 1e-5 of each
    leaf's largest entry."""
    jcfg, tcfg = _moe_cfgs(n_shared_experts=1, shared_d_ff=32,
                           capacity_factor=1.0)
    params = _moe_params(jcfg)
    x = np.random.default_rng(4).standard_normal(
        (P, 2, 128, 16)).astype(np.float32)

    def jf(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return (y * y).sum() + aux["lb_loss"] + aux["z_loss"]

    jg = jax.vmap(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(True), params_from_numpy(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    total = (y * y).sum() + aux["lb_loss"].sum() + aux["z_loss"].sum()
    leaves = [t for _, t in _paths(tp)] + [tx]
    grads = torch.autograd.grad(total, leaves)
    want = dict(_paths(jax.tree.map(np.asarray, jg[0])))
    for (path, _), g in zip(_paths(tp), grads):
        assert _rel(g.numpy(), want[path]) < 1e-5, path
    assert _rel(grads[-1].numpy(), np.asarray(jg[1])) < 1e-5
    assert float(grads[0].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------

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


def _stacked(inits):
    return jax.tree.map(lambda *x: np.stack(x), *inits)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(name):
    """The smoke model at P = 2: loss with the aux term, the three aux
    metrics and every leaf's grad against the reference's within 1e-5
    relative; the port's own init builds the reference's tree layout."""
    jcfg, tcfg = _cfgs(name)
    params = _stacked(_inits(name))
    batch = jsynthetic.lm_batch(np.random.default_rng(1), 2, 24,
                                jcfg.vocab_size)
    (jloss, jm), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: japi.loss_fn(p, batch, jcfg), has_aux=True)))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg))(params_from_numpy(params), tb)
    assert _rel(tloss.numpy(), np.asarray(jloss)) < 1e-5
    _, metrics = tapi.loss_fn(params_from_numpy(params), tb, tcfg)
    assert set(metrics) == set(jm) == {"loss", "lb_loss", "z_loss",
                                       "dropped_frac"}
    for k in ("loss", "lb_loss", "z_loss"):
        assert _rel(metrics[k].numpy(), np.asarray(jm[k])) < 1e-5, k
    # a fraction of assignments: the jitted reference's 1 - mean(keep)
    # over all-kept layers rounds to -6e-8
    assert np.abs(metrics["dropped_frac"].numpy()
                  - np.asarray(jm["dropped_frac"])).max() < 1e-6
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    got = dict(_paths(tgrads))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < 1e-5, path
    own = dict(_paths(tapi.init_params(torch.Generator().manual_seed(0),
                                       tcfg)))
    assert {p: tuple(t.shape) for p, t in own.items()} == \
        {p: tuple(x.shape[1:]) for p, x in want.items()}


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_paged_prefill_decode_and_window_match_jax(name):
    """Paged prefill of two prompts, three greedy decode steps and a verify
    window over the same pool: logits within 1e-4, pages within 1e-4, the
    greedy BMA tokens equal."""
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(_inits(name))
    tparams = params_from_numpy(stacked)
    jparams = jax.tree.map(jnp.asarray, stacked)
    ps, NP, n_pmax = 8, 16, 6
    jpages = jax.vmap(lambda _: japi.paged_cache_init(
        jcfg, num_pages=NP + 1, page_size=ps, dtype=jnp.float32))(
        jnp.arange(P))
    tpages = tree_map(lambda a: torch.zeros((P,) + tuple(a.shape)),
                      tapi.paged_cache_init(tcfg, num_pages=NP,
                                            page_size=ps, device="cpu"))
    rng = np.random.default_rng(5)
    lens = [13, 5]
    bts = np.array([[2, 3, 4, 5, 0, 0], [9, 10, 11, 0, 0, 0]], np.int32)
    toks = []
    jprefill = jax.jit(jax.vmap(lambda p, t, pg, bt, n: japi.prefill_paged(
        p, t, pg, bt, n, jcfg), in_axes=(0, None, 0, None, None)))
    jdecode = jax.jit(jax.vmap(lambda p, t, pg, bt, sl: japi.decode_step_paged(
        p, t, pg, bt, sl, jcfg, decode_kernel=False),
        in_axes=(0, None, 0, None, None)))
    for b, L in enumerate(lens):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :L] = rng.integers(1, jcfg.vocab_size, L)
        jl, jpages = jprefill(jparams, jnp.asarray(prompt), jpages,
                              jnp.asarray(bts[b]), jnp.int32(L))
        tl, tpages = tapi.prefill_paged(
            tparams, torch.from_numpy(prompt), tpages,
            torch.from_numpy(bts[b]), L, tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
        toks.append(int(np.asarray(jl).mean(0).argmax()))
        assert toks[-1] == int(tl.mean(0).argmax())
    sl = np.asarray(lens, np.int32)
    for step in range(3):
        tok = np.asarray(toks[-2:], np.int32)
        jl, jpages = jdecode(jparams, jnp.asarray(tok), jpages,
                             jnp.asarray(bts), jnp.asarray(sl))
        tl, tpages = tapi.decode_step_paged(
            tparams, torch.from_numpy(tok), tpages, torch.from_numpy(bts),
            torch.from_numpy(sl), tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, step
        jt = np.asarray(jl).mean(0).argmax(-1)
        assert np.array_equal(jt, tl.numpy().mean(0).argmax(-1))
        toks.extend(int(t) for t in jt)
        sl = sl + 1
    W = 3
    win = rng.integers(1, jcfg.vocab_size, (2, W)).astype(np.int32)
    wl = np.asarray([W, 2], np.int32)
    jl, jpages = jax.vmap(lambda p, pg: japi.decode_window_paged(
        p, jnp.asarray(win), pg, jnp.asarray(bts), jnp.asarray(sl),
        jnp.asarray(wl), jcfg, decode_kernel=False))(jparams, jpages)
    tl, tpages = tapi.decode_window_paged(
        tparams, torch.from_numpy(win), tpages, torch.from_numpy(bts),
        torch.from_numpy(sl), torch.from_numpy(wl), tcfg)
    jl = np.asarray(jl)
    assert _rel(tl.numpy()[:, 0], jl[:, 0]) < 1e-4
    assert _rel(tl.numpy()[:, 1, :2], jl[:, 1, :2]) < 1e-4
    want = dict(_paths(jax.tree.map(np.asarray, jpages)))
    for path, leaf in _paths(tpages):
        assert np.abs(leaf.numpy()[:, :NP] - want[path][:, :NP]).max() \
            < 1e-4, path


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_dense_prefill_and_decode_match_jax(name):
    """Dense-cache prefill and four greedy decode steps: logits within
    1e-4, the greedy tokens equal, the caches within 1e-4."""
    jcfg, tcfg = _cfgs(name)
    stacked = _stacked(_inits(name))
    tparams = params_from_numpy(stacked)
    L, steps = 11, 4
    prompts = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (3, L)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jl, jc = jax.jit(jax.vmap(lambda p: japi.prefill(
        p, {"tokens": jnp.asarray(prompts)}, jcfg, max_len=L + steps)))(
        jparams)
    jdecode = jax.jit(jax.vmap(lambda p, t, c, pos: japi.decode_step(
        p, t, c, pos, jcfg), in_axes=(0, None, 0, None)))
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L + steps)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    for step in range(steps):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().mean(0).argmax(-1))
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc, jnp.int32(L + step))
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  L + step, tcfg)
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, step
    jk = np.asarray(jc["units"][0]["k"])
    assert np.abs(tc["units"][0]["k"].numpy() - jk).max() < 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_module(jcfg):
    return JModule(init=lambda r: japi.init_params(r, jcfg),
                   loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                   forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                   cfg=jcfg)


def _jax_plain(jcfg, prompts, max_new, **kw):
    """The reference's PLAIN scheduler over 2 particles: (stacked params,
    generations)."""
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        stacked = jpd.store.stacked("params")
        svc = jserve_decode(jpd, jcfg, decode_kernel=False, warmup=False,
                            **kw)
        try:
            gens = [h.result(300) for h in
                    [svc.generate_async(p, max_new=max_new) for p in prompts]]
        finally:
            svc.close()
    return stacked, gens


def _port_pd(tcfg, stacked):
    tparams = _to_port(stacked)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(P):
        pd.p_create(params=tree_map(lambda a: a[p], tparams))
    return pd


def test_moe_serve_decode_plain_and_speculative_match_reference():
    """deepseek's smoke model, 4 prompts of mixed lengths over 3 rows: the
    port's plain and speculative schedulers emit the reference plain
    scheduler's tokens, logprobs within 1e-4, and drain the pool."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size,
                                          int(rng.integers(3, 15)))))
               for _ in range(4)]
    kw = dict(num_pages=32, page_size=8, max_active=3)
    stacked, plain = _jax_plain(jcfg, prompts, 5, **kw)
    for spec in (None, SpecConfig(k_max=3)):
        svc = serve_decode(_port_pd(tcfg, stacked), tcfg, speculative=spec,
                           warmup=False, **kw)
        try:
            got = [h.result(300) for h in
                   [svc.generate_async(p, max_new=5) for p in prompts]]
            st = svc.stats()
        finally:
            svc.close()
        for a, b in zip(plain, got):
            assert a.tokens == b.tokens, spec
            np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)
        assert st["pool"]["used_pages"] == 0
        if spec is not None:
            assert st["speculative"]["verify_calls"] == st["steps"]


def _lm_forward(cfg):
    def fwd(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], cfg)
    return fwd


def test_moe_stateful_engine_matches_jax_engine():
    """``PredictiveEngine(stateful=True)`` over a deepseek smoke store of
    2 particles: the heads of 4 greedy steps within 1e-4 of the
    reference's engine."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    L, max_new = 9, 4
    prompts = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg), store=jpd.store,
            stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + max_new)[1])
        stacked = jpd.store.stacked("params")
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(max_new):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    pd = _port_pd(tcfg, stacked)
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
        assert np.array_equal(tok.numpy(), np.asarray(
            jheads[step]["mean"]).argmax(-1))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_moe_fused_ensemble_epoch_matches_jax():
    """One fused DeepEnsemble epoch (3 batches, sgd 0.05) of deepseek's
    smoke model over 2 particles against the reference's jitted
    ``functional.ensemble_step`` from the same inits: every step's loss
    and the params within 1e-4."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    inits = _inits("deepseek-moe-16b")
    jopt = jsgd(0.05)
    jstep = jax.jit(jfunctional.ensemble_step(
        lambda p, b: japi.loss_fn(p, b, jcfg), jopt))
    jp = jax.tree.map(jnp.asarray, _stacked(inits))
    js = jax.vmap(jopt.init)(jp)
    loader = dict(batch_size=2, seq_len=16, num_batches=3, seed=0)
    from repro.data import DataLoader as JDataLoader
    jlosses = []
    for b in JDataLoader(jcfg, **loader):
        jp, js, ls = jstep(jp, js, b)
        jlosses.append(np.asarray(ls))
    _, tmod = _modules(jcfg, tcfg, inits)
    steps = []
    orig = tmod.loss
    tmod.loss = lambda p, b: (lambda r: (steps.append(r[0].detach()), r)[1])(
        orig(p, b))
    algo = DeepEnsemble(tmod, backend="compiled", device="cpu")
    algo.bayes_infer(DataLoader(tcfg, **loader), 1, num_particles=P,
                     optimizer=toptim.sgd(0.05))
    for got, want in zip(steps, jlosses):
        assert _rel(got.numpy(), want) < 1e-4
    want = np.stack([_flat_jax(jax.tree.map(lambda x: x[i], jp))
                     for i in range(P)])
    got = np.stack([_flat_torch(p) for p in algo.p_parameters()])
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_step_bodies_never_sync_the_host(name):
    """The MoE train step over 3 slots, one dead, and a paged decode and
    prefill step under the dispatch mode that raises on ``nonzero``,
    ``_local_scalar_dense`` and ``is_nonzero``: routing, capacity and
    the dispatch keep every shape fixed on the device."""
    _, tcfg = _cfgs(name)
    inits = _inits(name, 3)
    params = params_from_numpy(_stacked(inits))
    batch = {k: torch.from_numpy(v) for k, v in jsynthetic.lm_batch(
        np.random.default_rng(1), 2, 16, tcfg.vocab_size).items()}
    opt = toptim.adam(1e-3)
    state = tree_map(lambda *x: torch.stack(x), *[
        opt.init(params_from_numpy(i)) for i in inits])
    spec = specs.ensemble_step(lambda p, b: tapi.loss_fn(p, b, tcfg), opt)
    args = (params, state, batch, torch.tensor([1.0, 0.0, 1.0]))
    prog = eager(spec, args)
    pages = tree_map(lambda a: torch.zeros((3,) + tuple(a.shape)),
                     tapi.paged_cache_init(tcfg, num_pages=8, page_size=4,
                                           device="cpu"))
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    with NoHostSync():
        out = prog(*args)
        tapi.prefill_paged(params, torch.ones((1, 8), dtype=torch.int32),
                           pages, bt[0], torch.tensor(5), tcfg)
        tapi.decode_step_paged(params, torch.ones(2, dtype=torch.int32),
                               pages, bt, torch.tensor([5, -1],
                                                       dtype=torch.int32),
                               tcfg)
    assert all(bool(torch.isfinite(x).all()) for _, x in _paths(out))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_moe_store_checkpoints_both_ways(tmp_path):
    """A deepseek smoke store of 2 particles (the (E, D, F) expert leaves
    included) saved by each package and restored by the other: equal
    bytes leaf for leaf, and the two files hold the same arrays under the
    same names in the same (``jax.tree``) order."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    with JPD(_jax_module(jcfg), num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        want = jax.tree.map(np.asarray, jpd.store.stacked("params"))
        jfile = jckpt.save_store(str(tmp_path / "ref"), 3, jpd.store)
    pd = _port_pd(tcfg, want)
    _, restored = tckpt.restore_store(str(tmp_path / "ref"), device="cpu")
    got = dict(_paths(restored.stacked("params")))
    flat = dict(_paths(want))
    assert set(got) == set(flat)
    assert any(x.ndim == 5 for x in flat.values())   # (P, n_units, E, D, F)
    for path, x in flat.items():
        assert np.array_equal(got[path].numpy(), x), path
    tfile = tckpt.save_store(str(tmp_path / "port"), 3, pd.store)
    _, back = jckpt.restore_store(str(tmp_path / "port"))
    back = dict(_paths(jax.tree.map(np.asarray, back.stacked("params"))))
    for path, x in flat.items():
        assert np.array_equal(back[path], x), path
    jz, tz = np.load(jfile), np.load(tfile)
    assert jz.files == tz.files
    for n in jz.files:
        if n != "__store_manifest__":
            assert np.array_equal(jz[n], tz[n]), n
    jm, tm = (json.loads(str(z["__store_manifest__"])) for z in (jz, tz))
    assert jm["keys"] == tm["keys"] and '"moe"' in json.dumps(jm["keys"])
