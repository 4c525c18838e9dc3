"""The model axis (2D ``data x model`` placement) against the reference's
single-device runs, on the CPU: the port's counterpart of
``tests/_sharded_2d_check.py``.

Four logical positions of the CPU arranged as ``data=2 x model=2``
(``make_bench_mesh(4, model=2, devices=["cpu"] * 4)``): each particle's
q/k/v and MLP columns, ``wo`` / ``w2`` rows, vocab and kv heads split over
a model group of two positions, the rest replicated at both. The
reference side runs single-device, in this process. Weights cross over
from the reference (``tests/test_torch_train.py``'s tiny ViT,
``tests/test_torch_speculative.py``'s tiny qwen). Held:

  * fused DeepEnsemble, SteinVGD (median heuristic) and MultiSWAG within
    1e-4 of the reference's compiled runs (losses, params, predictions,
    SWAG means), zero ``stacks`` / ``unstacks`` / ``device_puts`` /
    ``checkouts`` inside the epoch loop, one capture per data position
    per step kind (SVGD: the force once), every replicated copy bit-equal
    after training;
  * the BMA predict within 1e-4 of the reference's ``serve`` with no
    capture by a second service, and the MultiSWAG posterior sampled per
    model shard;
  * paged decode token-exact against the reference's plain scheduler,
    each position's pool holding its kv heads, also with one kv head
    (the axis does not divide it: the pool is replicated) and with
    speculative decode;
  * the dense-cache (stateful) engine within 1e-4 of the reference's
    engine on 2 x 2, and the reference's stateful regression case on a
    particle-only mesh and on 2 x 2;
  * a llama3-8b stand-in's per-device param bytes on a model-only 1 x 4
    plan more than 3x below the replicated plan's, through
    ``pd.stats()["placement"]``;
  * a 2 x 2 store's checkpoint read by the reference, the reference's
    restored onto 2 x 2 (serving its tokens), and the 2 x 2 file's arrays
    equal to the one-device store's bit for bit;
  * deepseek-moe-16b's smoke model on 2 x 2 (each position holding 2 of
    the 4 experts, half the shared expert's columns and 2 of the 4 kv
    heads): paged decode, plain and speculative, token-exact against the
    reference's plain scheduler, a fused DeepEnsemble epoch within 1e-4
    of the reference's compiled run, and the aux metrics of the loss; 3
    experts (the axis does not divide them) replicated at both
    positions; gemma3-4b's smoke model (``local`` rings) in the
    dense-cache engine on 2 x 2 within 1e-4 of the reference's engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.data import DataLoader as JDataLoader
from repro.models import api as japi
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.serve import PredictiveEngine as JEngine
from repro.serve import serve as jserve
from repro import configs as jconfigs
from repro_torch import checkpoint
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.store import Placement, Sharded
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import Group, tree_leaves, tree_map
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.launch import make_bench_mesh
from repro_torch.models import api as tapi
from repro_torch.optim import adam, sgd
from repro_torch.runtime import ProgramCache
from repro_torch.serve import PredictiveEngine, serve, serve_decode
from repro_torch.sharding.rules import named_leaves
from test_torch_lifecycle import _ref_plain
from test_torch_placement import (ADAM_LR, ALGOS, TRAFFIC, N, _held, _mesh,
                                  _train)
from test_torch_speculative import _cfgs as _lm_cfgs
from test_torch_speculative import _jax_stacked, _to_port
from test_torch_train import _flat_jax, _flat_torch, _modules


def _two(model=2):
    return Placement(mesh=make_bench_mesh(4, model=model,
                                          devices=["cpu"] * 4))


def _replicas_equal(tree):
    """Every replicated leaf bit-equal across each model group."""
    for grp in tree.shards:
        assert isinstance(grp, Group) and len(grp) == 2
        first = named_leaves(grp[0])
        for shard in grp.shards[1:]:
            for (path, a), (_, b) in zip(first, named_leaves(shard)):
                if grp.dims[path] is None:
                    assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def trained():
    return {name: _train(name, _two()) for name in ALGOS}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_2d_training_matches_the_reference(trained, name):
    jalgo, talgo, jloss, tloss, loader, cache = trained[name]
    kinds = ALGOS[name][3]
    captures = 2 * kinds if kinds else 2 + 1 + 2
    assert cache.snapshot_stats()["cold_compiles"] == captures
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        assert np.abs(_flat_torch(tp) - _flat_jax(jp)).max() < 1e-4
    x = next(iter(JDataLoader(jalgo.module.cfg, batch_size=5, num_batches=1,
                              seed=3)))
    want = np.asarray(jalgo.posterior_pred(x))
    got = talgo.posterior_pred({k: torch.from_numpy(np.asarray(v))
                                for k, v in x.items()})
    assert np.abs(got.numpy() - want).max() < 1e-4
    st = talgo.store.stacked("params")
    assert isinstance(st, Sharded) and st.bounds == (0, 4, 8)
    grp = st.shards[0]
    # the model axis engaged: q columns and w2 rows split, the head whole
    assert grp.dims["units/attn/wq/w"] == -1
    assert grp.dims["units/mlp/w2/w"] == -2
    assert grp.dims["head/w"] is None and grp.dims["units/mlp/w2/b"] is None
    assert grp[0]["units"]["attn"]["wq"]["w"].shape[-1] * 2 \
        == jalgo.module.cfg.n_heads * jalgo.module.cfg.hd
    for key in ("params",) + (("swag", "opt_state") if name == "multiswag"
                              else ("opt_state",) if name == "ensemble"
                              else ()):
        _replicas_equal(talgo.store.stacked(key))
    first, last = loader.seen[0], loader.seen[-1]
    assert {k: last[k] - first[k] for k in TRAFFIC} == dict.fromkeys(
        TRAFFIC, 0)
    if name == "multiswag":
        for pid, jpid in zip(talgo.push_dist.particle_ids(),
                             jalgo.push_dist.particle_ids()):
            tsw = talgo.push_dist.particles[pid].state["swag"]
            jsw = jalgo.push_dist.particles[jpid].state["swag"]
            assert int(tsw["rank"]) == int(jsw["rank"])
            assert np.abs(_flat_torch(tsw["mean"])
                          - _flat_jax(jsw["mean"])).max() < 1e-4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_2d_lm_training_matches_the_reference(monkeypatch, opt):
    """A tiny qwen DeepEnsemble (4 particles, one epoch of 2 batches) on
    2 x 2 against the reference's single-device compiled run: the
    tensor-parallel loss (vocab-split embedding and logits, the loss in
    three chunks with padding, each under its checkpoint, every unit
    under the "nothing_saveable" remat) and its backward. Losses within
    1e-4; params within 1e-4 (Adam where the first |g| > G_HOLD, the
    rest counted, as ``test_torch_placement`` holds Adam); replicated
    copies bit-equal; one capture per data position."""
    monkeypatch.setattr(tapi, "LOSS_CHUNK", 10)
    jcfg, tcfg = _lm_cfgs()
    tcfg = tcfg.replace(remat_policy="nothing_saveable")
    n, b, s = 4, 2, 24
    stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, n))
    inits = [jax.tree.map(lambda x, i=i: x[i], stacked) for i in range(n)]
    jmod, tmod = _modules(jcfg, tcfg, inits)
    jopt, topt = ((jsgd(1e-2), sgd(1e-2)) if opt == "sgd"
                  else (jadam(ADAM_LR), adam(ADAM_LR)))
    jalgo = JDeepEnsemble(jmod, backend="compiled", capacity=n)
    talgo = DeepEnsemble(tmod, backend="compiled", capacity=n, device="cpu",
                         placement=_two())
    cache = talgo.push_dist.runtime.cache = ProgramCache()
    _, jloss = jalgo.bayes_infer(
        JDataLoader(jcfg, batch_size=b, seq_len=s, num_batches=2, seed=0), 1,
        num_particles=n, optimizer=jopt)
    tloader = DataLoader(tcfg, batch_size=b, seq_len=s, num_batches=2,
                         seed=0)
    _, tloss = talgo.bayes_infer(tloader, 1, num_particles=n,
                                 optimizer=topt)
    assert cache.snapshot_stats()["cold_compiles"] == 2
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    got = np.stack([_flat_torch(p) for p in talgo.p_parameters()])
    want = np.stack([_flat_jax(p) for p in jalgo.p_parameters()])
    if opt == "sgd":
        assert np.abs(got - want).max() < 1e-4
    else:
        tb = {k: torch.as_tensor(v) for k, v in next(iter(tloader)).items()}
        g1 = ensemble_value_and_grad(tmod.loss)(params_from_numpy(stacked),
                                                tb)[1]
        g1 = np.stack([_flat_torch(tree_map(lambda x, i=i: x[i], g1))
                       for i in range(n)])
        _held(got, want, g1)
    st = talgo.store.stacked("params")
    grp = st.shards[0]
    assert grp.dims["embed"] == -2 and grp.dims["units/0/mlp/wo/w"] == -2
    assert grp[0]["embed"].shape[-2] * 2 == tcfg.vocab_size
    _replicas_equal(st)
    _replicas_equal(talgo.store.stacked("opt_state"))


def test_2d_bma_predict_matches_the_reference(trained):
    jalgo, talgo, _, _, _, _ = trained["ensemble"]
    x = {"images": next(iter(JDataLoader(jalgo.module.cfg, batch_size=5,
                                         num_batches=1, seed=9)))["images"]}
    cache = ProgramCache()
    with jserve(jalgo) as jsvc:
        want, jmembers = jsvc.predict_batch(x, members=True)
    with serve(talgo, placement=_two(), warmup=False, cache=cache) as svc:
        before = talgo.store.snapshot_stats()
        heads = svc.predict_batch(x)
        _, members = svc.predict_batch(x, members=True)
        after = talgo.store.snapshot_stats()
        assert {k: after[k] - before[k] for k in TRAFFIC} == dict.fromkeys(
            TRAFFIC, 0)
        assert isinstance(svc.engine.stacked_params().shards[0], Group)
    for k, v in want.items():
        assert np.abs(heads[k].numpy() - np.asarray(v)).max() < 1e-4, k
    assert np.abs(members.numpy() - np.asarray(jmembers)).max() < 1e-4
    captured = cache.snapshot_stats()["cold_compiles"]
    assert captured == 2 * (2 + 1)      # per data position, per members
    with serve(talgo, warmup=False, cache=cache) as svc:
        again = svc.predict_batch(x)
    assert cache.snapshot_stats()["cold_compiles"] == captured
    assert torch.equal(again["mean"], heads["mean"])
    pl = talgo.push_dist.stats()["placement"]
    assert pl["mesh_shape"] == {"data": 2, "model": 2}
    assert pl["model_axis_size"] == 2 and pl["mode"] == "tp"
    assert pl["per_device_param_bytes"] > 0


def test_multiswag_posterior_sampled_per_model_shard(trained):
    _, talgo, _, _, _, _ = trained["multiswag"]
    x = {"images": next(iter(DataLoader(talgo.module.cfg, batch_size=3,
                                        num_batches=1, seed=5)))["images"]}
    out = {}
    for name, pl in (("one", Placement()), ("two", _two())):
        with talgo.posterior_predictive(
                samples_per_particle=2, placement=pl, warmup=False,
                generator=torch.Generator().manual_seed(0)) as svc:
            params = svc.engine.stacked_params()
            assert isinstance(params, Sharded) == (name == "two")
            out[name] = svc.predict_batch(x)
    for k in out["one"]:
        assert (out["one"][k] - out["two"][k]).abs().max() < 1e-4, k


def _lm_rows(kv=None):
    jcfg, tcfg = _lm_cfgs()
    if kv is not None:
        jcfg, tcfg = (c.replace(n_kv_heads=kv) for c in (jcfg, tcfg))
    stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, 4))
    rows = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(4)]
    return jcfg, tcfg, rows


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in (5, 9)]


@pytest.mark.parametrize("kv,speculative", [(None, None), (1, None),
                                            (None, 2)])
def test_2d_paged_decode_is_token_exact(kv, speculative):
    """Two kv heads split one a position; one kv head (the axis does not
    divide it) replicated at both; speculative decode drafting on the
    drafter's data position."""
    jcfg, tcfg, rows = _lm_rows(kv)
    prompts = _prompts(tcfg.vocab_size)
    want = _ref_plain(jcfg, rows, prompts, 5)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), capacity=4,
                          device="cpu", placement=_two())
    for r in rows:
        pd.p_create(params=_to_port(r))
    cache = ProgramCache()
    svc = serve_decode(pd, tcfg, num_pages=16, page_size=8, max_active=2,
                       warmup_buckets=(8, 16), speculative=speculative,
                       cache=cache)
    try:
        warm = cache.snapshot_stats()["cold_compiles"]
        got = [svc.generate(p, max_new=5) for p in prompts]
        assert cache.snapshot_stats()["cold_compiles"] == warm
        pages = pd.store.stacked("kv_pages")
        grp = pages.shards[0]
        heads = grp[0]["units"][0]["k"].shape[-2]
        assert heads == (1 if kv == 1 else tcfg.n_kv_heads // 2)
        assert grp.dims["units/0/k"] == (None if kv == 1 else -2)
        if kv == 1:
            _replicas_equal(pages)
    finally:
        svc.close()
        pd.cleanup()
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def _lm_forward(cfg):
    def fwd(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], cfg)
    return fwd


def test_2d_dense_cache_engine_matches_the_reference():
    jcfg, tcfg, rows = _lm_rows()
    L, max_new = 10, 4
    prompts = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0, capacity=4) as jpd:
        for r in rows[:3]:
            jpd.p_create(params=jax.tree.map(jnp.asarray, r))
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg, decode_kernel=True),
            store=jpd.store, stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + max_new)[1])
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(max_new):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu",
                          capacity=4, placement=_two())
    for r in rows[:3]:
        pd.p_create(params=params_from_numpy(r))
    eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store, stateful=True)
    toks = torch.from_numpy(prompts)
    state = eng.init_state(lambda p: tapi.prefill(
        p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + max_new)[1])
    assert isinstance(state, Sharded) and isinstance(state.shards[0], Group)
    # each position's caches hold its kv heads
    k = state.shards[0][0]["units"][0]["k"]
    assert k.shape[-2] == tcfg.n_kv_heads // 2
    tok = toks[:, -1]
    for step in range(max_new):
        heads, state = eng.step(state, {"token": tok, "cur_pos": L - 1 + step})
        for key, want in jheads[step].items():
            assert np.abs(heads[key].numpy() - want).max() < 1e-4, (step, key)
        tok = heads["mean"].argmax(-1).to(torch.int32)
        assert tok.tolist() == jheads[step]["mean"].argmax(-1).tolist()


def _reg_module(seed=0):
    rng = np.random.default_rng(seed)
    inits = iter([{"w": rng.normal(size=(3, 2)).astype(np.float32),
                   "b": rng.normal(size=(2,)).astype(np.float32)}
                  for _ in range(8)])

    def fwd(p, b):
        return b["x"] @ p["w"] + p["b"][:, None, :]

    return ParticleModule(
        init=lambda gen: params_from_numpy(next(inits)),
        loss=lambda p, b: (((fwd(p, b) - b["y"]) ** 2).mean((1, 2)), {}),
        forward=fwd)


@pytest.mark.parametrize("placement", ["data4", "two"])
def test_stateful_regression_on_a_mesh(placement):
    """The reference's stateful case (``tests/_sharded_serve_check.py``):
    the serving state born per data position, two steps of the BMA with
    the state advancing, against the per-particle means; its params match
    no rule, so on 2 x 2 they are replicated and run at each group's first
    position."""
    pl = _mesh() if placement == "data4" else _two()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    batch = [{"x": x, "y": x @ torch.ones(3, 2)}]
    with DeepEnsemble(_reg_module(), backend="compiled", device="cpu",
                      capacity=4, placement=pl) as de:
        de.bayes_infer(batch, 2, optimizer=sgd(0.05), num_particles=4)
        member = [(x @ p["w"] + p["b"]).numpy()
                  for p in de.p_parameters()]
        ref_mean = np.mean(np.stack(member), 0)

        def step_fwd(p, state, b):
            out = b["x"] @ p["w"] + p["b"][:, None, :] \
                + state["acc"][:, None, None]
            state["acc"].add_(1.0)
            return out, state

        eng = PredictiveEngine(step_fwd, store=de.store, kind="regress",
                               stateful=True)
        state = eng.init_state(lambda p: {"acc": torch.zeros(
            p["w"].shape[0])})
        assert isinstance(state, Sharded)
        for step in range(2):
            heads, state = eng.step(state, {"x": x})
            err = np.abs(heads["mean"].numpy() - (ref_mean + step)).max()
            assert err < 1e-5, (step, err)


def test_model_only_footprint_of_a_llama3_stand_in():
    """1 x model=4 against a replicated plan: per-device param bytes drop
    more than 3x, reported by ``pd.stats()["placement"]``."""
    cfg = tconfigs.get("llama3-8b").replace(
        n_units=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=8,
        d_ff=128, vocab_size=256, max_seq_len=64)
    byts = {}
    for tag, model in (("replicated", 1), ("model4", 4)):
        pd = PushDistribution(ParticleModule(
            init=lambda g: tapi.init_params(g, cfg), cfg=cfg), device="cpu",
            placement=_two(model))
        try:
            pd.p_create()
            pd.store.stacked("params")
            st = pd.stats()["placement"]
            assert st["mesh_shape"] == {"data": 4 // model, "model": model}
            byts[tag] = st["per_device_param_bytes"]
        finally:
            pd.cleanup()
    assert byts["replicated"] / byts["model4"] > 3.0, byts


def _store_arrays(path):
    data = np.load(path, allow_pickle=False)
    return {k: data[k] for k in data.files if k != "__store_manifest__"}


def test_2d_checkpoints_cross_both_ways(tmp_path):
    jcfg, tcfg, rows = _lm_rows()
    prompts = _prompts(tcfg.vocab_size)
    stores = {}
    for tag, pl in (("one", None), ("two", _two())):
        pd = PushDistribution(ParticleModule(init=None, cfg=tcfg),
                              capacity=4, device="cpu", placement=pl)
        for r in rows:
            pd.p_create(params=_to_port(r))
        pd.store.stacked("params")
        stores[tag] = checkpoint.save_store(str(tmp_path / tag), 1, pd.store)
        pd.cleanup()
    one, two = (_store_arrays(stores[t]) for t in ("one", "two"))
    assert one.keys() == two.keys()
    for k in one:
        assert one[k].dtype == two[k].dtype and np.array_equal(one[k], two[k])
    # the reference reads the 2 x 2 store's file
    _, jstore = jckpt.restore_store(str(tmp_path / "two"))
    for pid, r in zip(jstore.pids, rows):
        got = jax.tree.map(np.asarray, jstore.read("params", pid))
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(r)))
    # the port restores the reference's file onto 2 x 2 and serves it
    module = JModule(init=None, loss=None, forward=None, cfg=jcfg)
    with JPD(module, num_devices=1, seed=0, capacity=4) as jpd:
        for r in rows:
            jpd.p_create(params=jax.tree.map(jnp.asarray, r))
        jckpt.save_store(str(tmp_path / "j"), 2, jpd.store)
    _, store = checkpoint.restore_store(str(tmp_path / "j"),
                                        placement=_two(), device="cpu")
    assert isinstance(store.stacked("params").shards[0], Group)
    _replicas_equal(store.stacked("params"))
    svc = serve_decode(store, tcfg, num_pages=16, page_size=8, max_active=2,
                       warmup_buckets=(8, 16))
    try:
        got = [svc.generate(p, max_new=5) for p in prompts]
    finally:
        svc.close()
    want = _ref_plain(jcfg, rows, prompts, 5)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_2d_refusals_name_what_is_left_out():
    """Adafactor over model shards (its factored moments are per leaf)
    and the int8 draft on a mesh raise, saying what to use instead."""
    from repro_torch.optim import adafactor
    from repro_torch.serve import SpecConfig
    jcfg, tcfg, rows = _lm_rows()
    module = ParticleModule(init=None,
                            loss=lambda p, b: tapi.loss_fn(p, b, tcfg),
                            cfg=tcfg)
    with DeepEnsemble(module, capacity=4, device="cpu", placement=_two(),
                      backend="compiled") as algo:
        pd = algo.push_dist
        for r in rows:
            pd.p_create(adafactor(1e-2), params=_to_port(r))
        tokens = torch.arange(10).reshape(2, 5) % tcfg.vocab_size
        with pytest.raises(NotImplementedError, match="adam or sgd"):
            algo._fused_epochs(pd.particle_ids(),
                               [{"tokens": tokens, "labels": tokens}], 1,
                               optimizer=adafactor(1e-2))
        with pytest.raises(NotImplementedError, match="int8 draft"):
            serve_decode(pd, tcfg, num_pages=16, page_size=8,
                         speculative=SpecConfig(k_max=2, quantized=True))


# ---------------------------------------------------------------------------
# the decoder-only zoo on the model axis: MoE and local layers
# ---------------------------------------------------------------------------

def _zoo_rows(name, n=4, **kw):
    jcfg = jconfigs.get(name).smoke().replace(**kw)
    tcfg = tconfigs.get(name).smoke().replace(**kw)
    stacked = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda k: japi.init_params(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(0), n)))
    return jcfg, tcfg, [jax.tree.map(lambda a, i=i: a[i], stacked)
                        for i in range(n)]


@pytest.mark.parametrize("experts,speculative", [(4, None), (4, 2),
                                                 (3, None)])
def test_2d_moe_paged_decode_is_token_exact(experts, speculative):
    """deepseek's smoke MoE on 2 x 2: each position routes every token
    and computes its 2 experts (3 experts: all 3 at both positions);
    tokens equal the reference's plain scheduler's, logprobs within
    1e-4."""
    jcfg, tcfg, rows = _zoo_rows("deepseek-moe-16b", n_experts=experts)
    prompts = _prompts(tcfg.vocab_size)
    want = _ref_plain(jcfg, rows, prompts, 5)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), capacity=4,
                          device="cpu", placement=_two())
    for r in rows:
        pd.p_create(params=_to_port(r))
    grp = pd.store.stacked("params").shards[0]
    wi = "units/0/moe/wi"
    if experts == 4:
        assert grp.dims[wi] == -3 and grp[0]["units"][0]["moe"]["wi"].shape[
            -3] == 2
    else:
        assert grp.dims[wi] is None
    assert grp.dims["units/0/moe/router/w"] is None
    svc = serve_decode(pd, tcfg, num_pages=16, page_size=8, max_active=2,
                       warmup=False, speculative=speculative)
    try:
        got = [svc.generate(p, max_new=5) for p in prompts]
    finally:
        svc.close()
        pd.cleanup()
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def test_2d_moe_training_matches_the_reference():
    """A deepseek smoke DeepEnsemble (4 particles, sgd, one epoch of 2
    batches) on 2 x 2 against the reference's single-device compiled run:
    losses (with the aux term) and params within 1e-4, replicated copies
    (the router among them) bit-equal; the tensor-parallel loss's aux
    metrics within 1e-5 of the one-device loss's."""
    jcfg, tcfg, inits = _zoo_rows("deepseek-moe-16b")
    n, b, s = 4, 2, 16
    jmod, tmod = _modules(jcfg, tcfg, inits)
    jalgo = JDeepEnsemble(jmod, backend="compiled", capacity=n)
    talgo = DeepEnsemble(tmod, backend="compiled", capacity=n, device="cpu",
                         placement=_two())
    _, jloss = jalgo.bayes_infer(
        JDataLoader(jcfg, batch_size=b, seq_len=s, num_batches=2, seed=0), 1,
        num_particles=n, optimizer=jsgd(1e-2))
    tloader = DataLoader(tcfg, batch_size=b, seq_len=s, num_batches=2,
                         seed=0)
    _, tloss = talgo.bayes_infer(tloader, 1, num_particles=n,
                                 optimizer=sgd(1e-2))
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    got = np.stack([_flat_torch(p) for p in talgo.p_parameters()])
    want = np.stack([_flat_jax(p) for p in jalgo.p_parameters()])
    assert np.abs(got - want).max() < 1e-4
    st = talgo.store.stacked("params")
    _replicas_equal(st)
    tb = {k: torch.as_tensor(v) for k, v in next(iter(tloader)).items()}
    two = tapi.loss_fn(st.shards[0], tb, tcfg)[1]
    one = tapi.loss_fn(params_from_numpy(jax.tree.map(
        lambda *x: np.stack(x), *[_flat_rows(p) for p in
                                  talgo.p_parameters()[:2]])), tb, tcfg)[1]
    for k in ("loss", "lb_loss", "z_loss", "dropped_frac"):
        assert (two[k] - one[k]).abs().max() < 1e-5, k


def _flat_rows(p):
    return tree_map(lambda x: x.detach().numpy(), p)


def test_2d_gemma_dense_cache_engine_matches_the_reference():
    """gemma3's smoke model (5 local ring layers, 1 global, 1 local tail)
    in the stateful engine on 2 x 2, prompts past the 16-token window:
    the heads of 5 greedy steps within 1e-4 of the reference's engine;
    each position's rings hold its 2 kv heads and 16 slots."""
    jcfg, tcfg, rows = _zoo_rows("gemma3-4b", n=2)
    L, max_new = 20, 5
    prompts = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, (2, L)).astype(np.int32)
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0, capacity=2) as jpd:
        for r in rows:
            jpd.p_create(params=jax.tree.map(jnp.asarray, r))
        jeng = JEngine(lambda p, c, b: japi.decode_step(
            p, b["token"], c, b["cur_pos"], jcfg, decode_kernel=True),
            store=jpd.store, stateful=True)
        jstate = jeng.init_state(lambda p: japi.prefill(
            p, {"tokens": jnp.asarray(prompts[:, :-1])}, jcfg,
            max_len=L + max_new)[1])
        tok, jheads = jnp.asarray(prompts[:, -1]), []
        for step in range(max_new):
            h, jstate = jeng.step(jstate, {"token": tok,
                                           "cur_pos": jnp.int32(L - 1 + step)})
            jheads.append({k: np.asarray(v) for k, v in h.items()})
            tok = jnp.argmax(h["mean"], -1).astype(jnp.int32)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu",
                          capacity=2, placement=_two())
    for r in rows:
        pd.p_create(params=params_from_numpy(r))
    eng = PredictiveEngine(_lm_forward(tcfg), store=pd.store, stateful=True)
    toks = torch.from_numpy(prompts)
    state = eng.init_state(lambda p: tapi.prefill(
        p, {"tokens": toks[:, :-1]}, tcfg, max_len=L + max_new)[1])
    k = state.shards[0][0]["units"][0]["k"]
    assert k.shape[-2] == tcfg.n_kv_heads // 2 and k.shape[-3] == 16
    tok = toks[:, -1]
    for step in range(max_new):
        heads, state = eng.step(state, {"token": tok, "cur_pos": L - 1 + step})
        for key, want in jheads[step].items():
            assert np.abs(heads[key].numpy() - want).max() < 1e-4, (step, key)
        tok = heads["mean"].argmax(-1).to(torch.int32)
