"""The particle axis on a device mesh, against the reference's
single-device compiled path, on the CPU.

Four logical positions of the CPU (``make_bench_mesh(4, devices=["cpu"]
* 4)``, the counterpart of the reference's forced host devices) hold the
store's particle axis: 6 particles in a store of capacity 8, so every
position holds 2 slots and the last one a dead slot. Inputs come from a
numpy seed (the seeded loaders), weights cross over from the reference
(``tests/test_torch_train.py``'s tiny ViT, ``tests/test_torch_
speculative.py``'s tiny qwen). Held:

  * the port's sharded DeepEnsemble, MultiSWAG and SteinVGD (median
    heuristic) against the reference's single-device compiled runs:
    losses and params within 1e-4 (and the SWAG moments), with zero
    ``stacks`` / ``unstacks`` / ``device_puts`` / ``checkouts`` inside
    the epoch loop and one capture per position per step kind (SVGD:
    the grads and the update at every position, the force once);
    DeepEnsemble and MultiSWAG again under Adam, the params and SWAG
    means held where the first step's |g| > 1e-5 (``_held``), every
    particle moved by at least 10x the bar;
  * the sharded BMA predict (``serve(placement=)``, heads and members)
    within 1e-5 of the reference's ``serve``, no stacked-state traffic
    per request, no capture by a second service over the same store and
    cache, and the MultiSWAG posterior split over the positions;
  * plain paged decode (``serve_decode(placement=)``) on a tiny qwen,
    token-exact against the reference's plain scheduler and equal to the
    unsharded port's tokens and logprobs, also on a one-device store that
    ``serve_decode(placement=)`` moves onto the mesh;
  * ``plan_key`` equal across separately built equal meshes and unequal
    across positions; a model axis above 1 placing, speculative and
    dense-cache serving on a mesh running; a mesh store's
    layout through growth, clones across positions, ``dense``,
    ``per_device_bytes`` and ``rebalance``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import SteinVGD as JSteinVGD
from repro.data import DataLoader as JDataLoader
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.serve import serve as jserve
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.functional import (ensemble_value_and_grad,
                                         flatten_stacked)
from repro_torch.core.store import ParticleStore, Placement, Sharded
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map
from repro_torch.data import DataLoader
from repro_torch.interop import params_from_numpy
from repro_torch.launch import make_bench_mesh, make_mesh
from repro_torch.optim import adam, sgd
from repro_torch.runtime import ProgramCache
from repro_torch.serve import PredictiveEngine, serve, serve_decode
from test_torch_lifecycle import _ref_plain
from test_torch_speculative import _cfgs as _lm_cfgs
from test_torch_speculative import _jax_stacked, _to_port
from test_torch_train import (_cfgs, _flat_jax, _flat_torch, _modules,
                              _numpy_inits)

N, CAP, EPOCHS, LR = 6, 8, 2, 0.05
TRAFFIC = ("stacks", "unstacks", "device_puts", "checkouts")
ALGOS = {
    "ensemble": (DeepEnsemble, JDeepEnsemble,
                 lambda opt: {"optimizer": opt}, 1),
    "multiswag": (MultiSWAG, JMultiSWAG,
                  lambda opt: {"optimizer": opt, "max_rank": 3,
                               "pretrain_epochs": 1}, 2),
    "svgd": (SteinVGD, JSteinVGD,
             lambda opt: {"lr": LR, "lengthscale": 0.0}, None),
}
# Adam's first update is about lr * sign(g): where |g| is rounding noise,
# a grad difference between the two sides at rounding level may move an
# entry by up to 2 lr on one side and not the other, and later steps keep
# that. The params are held within 1e-4 where the first step's |g| >
# G_HOLD, the entries under it counted (under 2%), as the LM's Adam runs
# are (tests/test_torch_lm_train.py).
ADAM_LR, G_HOLD = 1e-3, 1e-5


def _mesh(n=4):
    return Placement(mesh=make_bench_mesh(n, devices=["cpu"] * n))


class _Watched:
    """A loader that reads the store's counters when the epoch loop first
    asks for a batch and after it took the last one."""

    def __init__(self, loader, store):
        self.loader, self.store, self.seen = loader, store, []

    def __iter__(self):
        self.seen.append(self.store.snapshot_stats())
        yield from self.loader
        self.seen.append(self.store.snapshot_stats())


def _train(name, placement=None, adam_lr=None):
    """(reference algo, port algo, reference losses, port losses, loader,
    cache) for one algorithm, the port's store on ``placement``; sgd at LR,
    or Adam at ``adam_lr``."""
    cls, jcls, kw, _ = ALGOS[name]
    jopt, topt = ((jsgd(LR), sgd(LR)) if adam_lr is None
                  else (jadam(adam_lr), adam(adam_lr)))
    jcfg, tcfg = _cfgs()
    jmod, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    jalgo = jcls(jmod, backend="compiled", capacity=CAP)
    talgo = cls(tmod, backend="compiled", capacity=CAP, device="cpu",
                placement=placement)
    cache = talgo.push_dist.runtime.cache = ProgramCache()
    loader = _Watched(DataLoader(tcfg, batch_size=8, num_batches=2, seed=0),
                      talgo.store)
    _, jloss = jalgo.bayes_infer(
        JDataLoader(jcfg, batch_size=8, num_batches=2, seed=0), EPOCHS,
        num_particles=N, **kw(jopt))
    _, tloss = talgo.bayes_infer(loader, EPOCHS, num_particles=N, **kw(topt))
    return jalgo, talgo, jloss, tloss, loader, cache


def _held(got, want, g1, tol=1e-4):
    """``got`` within ``tol`` of ``want`` where the first |g| > G_HOLD, and
    the entries under it fewer than 2%."""
    big = np.abs(g1) > G_HOLD
    assert np.abs(got - want)[big].max() < tol
    assert (~big).sum() < 0.02 * big.size


@pytest.fixture(scope="module")
def trained():
    return {name: _train(name, _mesh()) for name in ALGOS}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_sharded_training_matches_the_reference(trained, name):
    jalgo, talgo, jloss, tloss, loader, cache = trained[name]
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    for jp, tp in zip(jalgo.p_parameters(), talgo.p_parameters()):
        assert np.abs(_flat_torch(tp) - _flat_jax(jp)).max() < 1e-4
    st = talgo.store.stacked("params")
    assert isinstance(st, Sharded) and st.bounds == (0, 2, 4, 6, 8)
    for leaf in tree_leaves(st.shards[3]):      # slots 6, 7: dead zeros
        assert torch.count_nonzero(leaf) == 0
    # nothing moves through the store inside the epoch loop
    first, last = loader.seen[0], loader.seen[-1]
    assert {k: last[k] - first[k] for k in TRAFFIC} == dict.fromkeys(
        TRAFFIC, 0)
    kinds = ALGOS[name][3]
    captures = 4 * kinds if kinds else 4 + 1 + 4
    assert cache.snapshot_stats()["cold_compiles"] == captures
    if name == "multiswag":
        for pid, jpid in zip(talgo.push_dist.particle_ids(),
                             jalgo.push_dist.particle_ids()):
            tsw = talgo.push_dist.particles[pid].state["swag"]
            jsw = jalgo.push_dist.particles[jpid].state["swag"]
            assert int(tsw["rank"]) == int(jsw["rank"])
            assert np.abs(_flat_torch(tsw["mean"])
                          - _flat_jax(jsw["mean"])).max() < 1e-4


@pytest.mark.parametrize("name", ["ensemble", "multiswag"])
def test_sharded_adam_training_matches_the_reference(name):
    """Adam (phase 4's optimizer for MultiSWAG) on the mesh against the
    reference's single-device compiled run: losses within 1e-4, the params
    and the SWAG means held where the first |g| > G_HOLD (``ADAM_LR``),
    and every particle moved by at least 10x the bar, so that an update a
    position dropped would show."""
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(jcfg, N)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in next(iter(
        DataLoader(tcfg, batch_size=8, num_batches=2, seed=0))).items()}
    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *[params_from_numpy(i) for i in inits])
    g1 = flatten_stacked(ensemble_value_and_grad(_modules(
        jcfg, tcfg, inits)[1].loss)(stacked, batch)[1])[0].numpy()
    jalgo, talgo, jloss, tloss, loader, cache = _train(name, _mesh(),
                                                       adam_lr=ADAM_LR)
    assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
    got = np.stack([_flat_torch(p) for p in talgo.p_parameters()])
    want = np.stack([_flat_jax(p) for p in jalgo.p_parameters()])
    _held(got, want, g1)
    moved = np.abs(got - np.stack([_flat_jax(i) for i in inits])).max(1)
    assert moved.min() > 10 * 1e-4
    first, last = loader.seen[0], loader.seen[-1]
    assert {k: last[k] - first[k] for k in TRAFFIC} == dict.fromkeys(
        TRAFFIC, 0)
    assert cache.snapshot_stats()["cold_compiles"] == 4 * ALGOS[name][3]
    if name == "multiswag":
        means = [(_flat_torch(talgo.push_dist.particles[p].state["swag"]
                              ["mean"]),
                  _flat_jax(jalgo.push_dist.particles[j].state["swag"]
                            ["mean"]))
                 for p, j in zip(talgo.push_dist.particle_ids(),
                                 jalgo.push_dist.particle_ids())]
        _held(np.stack([m[0] for m in means]),
              np.stack([m[1] for m in means]), g1)


def test_sharded_bma_predict_matches_the_reference(trained):
    jalgo, talgo, _, _, _, _ = trained["ensemble"]
    x = {"images": next(iter(JDataLoader(jalgo.module.cfg, batch_size=5,
                                         num_batches=1, seed=9)))["images"]}
    cache = ProgramCache()
    with jserve(jalgo) as jsvc:
        want, jmembers = jsvc.predict_batch(x, members=True)
    with serve(talgo, placement=_mesh(), warmup=False, cache=cache) as svc:
        assert svc.engine.placement == talgo.placement
        before = talgo.store.snapshot_stats()
        heads = svc.predict_batch(x)
        heads2, members = svc.predict_batch(x, members=True)
        after = talgo.store.snapshot_stats()
        assert {k: after[k] - before[k] for k in TRAFFIC} == dict.fromkeys(
            TRAFFIC, 0)
        assert isinstance(svc.engine.stacked_params(), Sharded)
        assert float(svc.engine.active_mask().sum()) == N
    for k, v in want.items():
        assert np.abs(heads[k].numpy() - np.asarray(v)).max() < 1e-5, k
        assert torch.equal(heads[k], heads2[k])
    assert np.abs(members.numpy() - np.asarray(jmembers)).max() < 1e-5
    captured = cache.snapshot_stats()["cold_compiles"]
    assert captured == 2 * (4 + 1)       # per bucket program, per members
    with serve(talgo, warmup=False, cache=cache) as svc:
        again = svc.predict_batch(x)
    assert cache.snapshot_stats()["cold_compiles"] == captured
    assert torch.equal(again["mean"], heads["mean"])


def test_multiswag_posterior_served_on_the_mesh(trained):
    _, talgo, _, _, _, _ = trained["multiswag"]
    x = {"images": next(iter(DataLoader(talgo.module.cfg, batch_size=3,
                                        num_batches=1, seed=5)))["images"]}
    out = {}
    for name, pl in (("one", Placement()), ("mesh", _mesh())):
        with talgo.posterior_predictive(
                samples_per_particle=2, placement=pl, warmup=False,
                generator=torch.Generator().manual_seed(0)) as svc:
            params = svc.engine.stacked_params()
            assert isinstance(params, Sharded) == (name == "mesh")
            out[name] = svc.predict_batch(x)
    for k in out["one"]:
        assert (out["one"][k] - out["mesh"][k]).abs().max() < 1e-5, k


def test_sharded_paged_decode_is_token_exact():
    jcfg, tcfg = _lm_cfgs()
    stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, 4))
    rows = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(4)]
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, n)]
               for n in (5, 9)]
    want = _ref_plain(jcfg, rows, prompts, 5)
    got = {}
    # "moved": a one-device store that serve_decode(placement=) reshards
    for name, pl, moved in (("one", None, None), ("mesh", _mesh(), None),
                            ("moved", None, _mesh())):
        pd = PushDistribution(ParticleModule(init=None, cfg=tcfg),
                              capacity=4, device="cpu", placement=pl)
        for r in rows:
            pd.p_create(params=_to_port(r))
        svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                           max_active=2, warmup_buckets=(8, 16),
                           placement=moved)
        try:
            st0 = pd.store.snapshot_stats()
            got[name] = [svc.generate(p, max_new=5) for p in prompts]
            st1 = pd.store.snapshot_stats()
            assert st1["stacks"] == st0["stacks"]
            assert st1["device_puts"] == st0["device_puts"]
            pages = pd.store.stacked("kv_pages")
            if name != "one":
                assert isinstance(pages, Sharded)
                assert [len(s) for s in (pages,)] == [4]
                assert svc.scheduler.queue_depth() == 0
        finally:
            svc.close()
            pd.cleanup()
    for w, a, b, c in zip(want, got["one"], got["mesh"], got["moved"]):
        assert b.tokens == w.tokens == a.tokens
        np.testing.assert_allclose(b.logprobs, a.logprobs, atol=1e-5)
        np.testing.assert_allclose(b.logprobs, w.logprobs, atol=1e-4)
        assert c.tokens == b.tokens and c.logprobs == b.logprobs


def test_plan_keys_and_item_10b_refusals():
    jcfg, tcfg = _lm_cfgs()
    a, b = _mesh(), _mesh()
    assert a is not b and a == b and a.plan_key() == b.plan_key()
    assert a.plan_key() != _mesh(2).plan_key()
    swapped = Placement(mesh=make_mesh((2, 1), ("data", "model"),
                                       devices=["cpu", "meta"]))
    other = Placement(mesh=make_mesh((2, 1), ("data", "model"),
                                     devices=["meta", "cpu"]))
    assert swapped != other
    # the model axis places (tests/test_torch_placement2d.py holds it)
    two = Placement(mesh=make_bench_mesh(4, model=2, devices=["cpu"] * 4))
    assert two.model_axis_size() == 2 and two.particle_axis_size() == 2
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), capacity=4,
                          device="cpu", placement=a)
    try:
        stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, 4))
        rows = [jax.tree.map(lambda x, i=i: x[i], stacked) for i in range(4)]
        for r in rows:
            pd.p_create(params=_to_port(r))
        # speculative serving on a mesh: token-exact against the plain
        # reference scheduler
        prompt = [3, 5, 7, 11, 13]
        with serve_decode(pd, tcfg, num_pages=16, page_size=8,
                          speculative=2, warmup_buckets=(8,)) as svc:
            got = svc.generate(prompt, max_new=4)
        assert got.tokens == _ref_plain(jcfg, rows, [prompt], 4)[0].tokens
        # dense-cache serving on a mesh: state born per position
        def step_fwd(p, s, b):      # the state is updated in place
            out = tree_leaves(p)[0].sum((1, 2))[:, None] + s["acc"][:, None]
            s["acc"].add_(1.0)
            return out, s

        eng = PredictiveEngine(step_fwd, store=pd.store, kind="regress",
                               stateful=True)
        state = eng.init_state(lambda p: {"acc": torch.zeros(
            tree_leaves(p)[0].shape[0])})
        assert isinstance(state, Sharded) and state.bounds == (0, 1, 2, 3, 4)
        heads, state = eng.step(state, {"x": torch.zeros(1)})
        heads2, state = eng.step(state, {"x": torch.zeros(1)})
        assert torch.allclose(heads2["mean"], heads["mean"] + 1.0)
        assert pd.store.placement == a
    finally:
        pd.cleanup()


def test_mesh_store_layout_through_churn_and_growth():
    pl = _mesh()
    store = ParticleStore(capacity=2, device="cpu", placement=pl)
    assert store.device == torch.device("cpu")
    for pid in range(2):
        store.register(pid)
        store.write("w", pid, {"a": torch.full((3,), float(pid))})
    # capacity 2 on 4 positions: not split (the axis does not divide it)
    assert not isinstance(store.stacked("w"), Sharded)
    for pid in range(2, 5):
        store.register(pid)
        store.write("w", pid, {"a": torch.full((3,), float(pid))})
    st = store.stacked("w")       # capacity 8: split, two slots a position
    assert isinstance(st, Sharded) and st.bounds == (0, 2, 4, 6, 8)
    assert store.snapshot_stats()["device_puts"] == 1
    assert [float(store.read("w", p)["a"][0]) for p in range(5)] == \
        [0.0, 1.0, 2.0, 3.0, 4.0]
    assert store.per_device_bytes("w") == 2 * 3 * 4
    assert store.per_particle_bytes("w") == 3 * 4
    # a clone across positions keeps every shard at its address
    ptrs = [x.data_ptr() for x in st.leaves()]
    store.register(7)
    store.clone_slot("w", 0, 7)
    assert store.slot_of(7) == 5
    assert [x.data_ptr() for x in store.stacked("w").leaves()] == ptrs
    assert float(store.read("w", 7)["a"][0]) == 0.0
    dense = store.dense("w")
    assert not isinstance(dense, Sharded)
    assert dense["a"][:, 0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 0.0]
    store.rebalance()
    assert store.stacked("w") is st or isinstance(store.stacked("w"),
                                                  Sharded)
    mask = store.active_mask()
    assert mask.tolist() == [1, 1, 1, 1, 1, 1, 0, 0]
    # a plain tree committed to a mesh store is placed (one device put)
    puts = store.snapshot_stats()["device_puts"]
    store.commit("z", {"b": torch.arange(8.0)[:, None]})
    z = store.stacked("z")
    assert isinstance(z, Sharded) and z.shards[2]["b"][:, 0].tolist() == \
        [4.0, 5.0]
    assert store.snapshot_stats()["device_puts"] == puts + 1
    flat, _ = tree_flatten(z.gather())
    assert flat[0][:, 0].tolist() == list(range(8))
