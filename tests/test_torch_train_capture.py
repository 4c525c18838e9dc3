"""What step capture asks of the train paths, on the CPU (port only).

The DeepEnsemble, SteinVGD and MultiSWAG steps, the SWAG collection and
the ensemble predict are ``ProgramSpec``s dispatched through the PD's
``CompiledRuntime``; on the card each is captured once as a CUDA graph.
At a tiny ViT-MNIST (2 layers, d_model 64) with 3 slots, one of them
dead in the masked cases:

  * every train body runs under a dispatch mode that raises on
    ``aten.nonzero``, ``aten._local_scalar_dense`` and ``aten.is_nonzero``
    (no host sync: the ensemble step with sgd and adam, the SVGD step at
    ell = 1 and with the median heuristic, masked and dense; the masked
    collection; the predict);
  * each ``"in:<i>"`` output is its argument's own leaves (the same
    ``data_ptr()``), updated in place, and a dead slot keeps every bit;
  * through a ``ProgramCache`` whose capturer counts captures: one
    capture per spec per fused run, none in a second fused run or a
    second ``bayes_infer`` on the same store, one more after the store
    grows;
  * a capture's warm-up is the first call: with a capturer that runs the
    body once when it builds the program (as ``program.capture`` does)
    and answers the first call from it only for the very same argument
    objects, N steps of a fused run equal N eager steps bit for bit, so
    the first batch is trained once.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.bdl.svgd import svgd_step_spec
from repro_torch.bdl.swag import swag_collect, swag_state_init
from repro_torch.core import ParticleModule
from repro_torch.core.tree import to_device, tree_leaves, tree_map
from repro_torch.data import DataLoader
from repro_torch.models import api
from repro_torch.optim import adam, sgd
from repro_torch.runtime import Program, ProgramCache, eager, specs

TINY = dict(n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128)
P, MAX_RANK, LR = 3, 3, 0.05
CFG = configs.get("vit-mnist").smoke().replace(**TINY)
MODULE = ParticleModule(init=lambda g: api.init_params(g, CFG),
                        loss=lambda p, b: api.loss_fn(p, b, CFG),
                        forward=lambda p, b: api.forward(p, b, CFG)[0],
                        cfg=CFG)

SYNCS = (torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
         torch.ops.aten.is_nonzero)


class NoHostSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in SYNCS:
            raise AssertionError(f"host sync in a step body: {func}")
        return func(*args, **(kwargs or {}))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return _stack([MODULE.init(gen) for _ in range(P)])


def _batch(seed=0):
    return to_device(next(iter(DataLoader(CFG, batch_size=4, num_batches=1,
                                          seed=seed))), "cpu")


def _swag_state(params):
    """A stacked SWAG state mid-run: counts 4, 1, 2 (row 0's ring has
    wrapped), random moments and ring."""
    gen = torch.Generator().manual_seed(5)
    state = _stack([swag_state_init(tree_map(lambda x: x[i], params),
                                    MAX_RANK) for i in range(P)])
    state = tree_map(lambda x: torch.randn(x.shape, generator=gen)
                     if x.dtype == torch.float32 else x, state)
    state["n"] = torch.tensor([4.0, 1.0, 2.0])
    state["rank"] = torch.tensor([4, 1, 2], dtype=torch.int32)
    return state


MASK = torch.tensor([1.0, 0.0, 1.0])
OPTIMIZERS = {"sgd": lambda: sgd(LR, momentum=0.9), "adam": lambda: adam(LR)}


def _case(name, masked):
    """(spec, args) of one train body on fresh state."""
    mask = MASK.clone() if masked else None
    params = _params()
    kind, _, arg = name.partition("-")
    if kind == "ensemble":
        opt = OPTIMIZERS[arg]()
        state = _stack([opt.init(tree_map(lambda x: x[i], params))
                        for i in range(P)])
        return (specs.ensemble_step(MODULE.loss, opt),
                (params, state, _batch(), mask))
    if kind == "svgd":
        return (svgd_step_spec(MODULE.loss, lr=LR, lengthscale=float(arg)),
                (params, _batch(), mask))
    if kind == "collect":
        return (specs.map_step(swag_collect, key=("swag_collect",),
                               n_state=2, masked=True),
                (_swag_state(params), params, mask))
    return specs.ensemble_predict(MODULE.forward), (params, _batch(), mask)


BODIES = ["ensemble-sgd", "ensemble-adam", "svgd-1.0", "svgd-0.0"]
SYNC_CASES = ([(b, m) for b in BODIES for m in (True, False)]
              + [("collect", True), ("predict", True)])


@pytest.mark.parametrize("name,masked", SYNC_CASES,
                         ids=[f"{b}-{'masked' if m else 'dense'}"
                              for b, m in SYNC_CASES])
def test_train_bodies_never_sync_the_host(name, masked):
    spec, args = _case(name, masked)
    prog = eager(spec, args)
    with NoHostSync():
        out = prog(*args)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out))


def _bits(x):
    return x.reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("name", BODIES + ["collect"])
def test_train_bodies_update_their_state_in_place(name):
    """Every "in:<i>" output is argument i's own leaves; the dead slot (1)
    keeps every bit of every in-place tree, and the live slots move."""
    spec, args = _case(name, masked=True)
    before = [tree_map(torch.clone, a) for a in args]
    out = eager(spec, args)(*args)
    pairs = [(o, int(k[3:])) for o, k in enumerate(spec.out_kinds)
             if k.startswith("in:")]
    assert pairs and len(out) == len(spec.out_kinds)
    for o, i in pairs:
        got, own = tree_leaves(out[o]), tree_leaves(args[i])
        assert [x.data_ptr() for x in got] == [x.data_ptr() for x in own]
        moved = False
        for new, old in zip(own, tree_leaves(before[i])):
            assert torch.equal(_bits(new[1]), _bits(old[1]))
            moved |= not torch.equal(new[[0, 2]], old[[0, 2]])
        assert moved
    if "vector" in spec.out_kinds:      # the losses: 0.0 in the dead slot
        losses = out[spec.out_kinds.index("vector")]
        assert losses[1] == 0.0 and bool((losses[[0, 2]] > 0).all())


# ---------------------------------------------------------------------------
# the programs of a fused run, through the PD's ProgramCache
# ---------------------------------------------------------------------------

class Counting:
    """A capturer that counts its captures and the calls of the programs
    it made, each run as the eager body."""

    def __init__(self):
        self.captured, self.calls = [], 0

    def __call__(self, spec, args, cache_key=None):
        self.captured.append(spec.name)
        prog = eager(spec, args, cache_key)

        def run(*call_args):
            self.calls += 1
            return prog(*call_args)

        return Program(spec.name, cache_key, prog.num_particles, fn=run,
                       in_kinds=spec.in_kinds)


ALGOS = {
    "ensemble": (DeepEnsemble, ["ensemble_step"]),
    "svgd": (SteinVGD, ["svgd_step"]),
    "multiswag": (MultiSWAG, ["ensemble_step", "map_step"]),
}


def _algo(name, capturer):
    algo = ALGOS[name][0](MODULE, seed=0, backend="compiled", device="cpu")
    algo.push_dist.runtime.cache = ProgramCache(capturer=capturer)
    return algo


def _fused_kw(name, opt):
    """The keywords of ``name``'s ``_fused_epochs``."""
    if name == "svgd":
        return {"lr": LR, "lengthscale": 0.0}
    if name == "ensemble":
        return {"optimizer": opt}
    return {"optimizer": opt, "pretrain_epochs": 1}


def _infer_kw(name, opt):
    """The keywords of ``name``'s ``bayes_infer``."""
    kw = _fused_kw(name, opt)
    return {**kw, "max_rank": MAX_RANK} if name == "multiswag" else kw


def _loader(n=3, seed=0):
    return DataLoader(CFG, batch_size=4, num_batches=n, seed=seed)


def _new_particles(algo, name, opt, n):
    if name == "multiswag":
        return algo._create(opt, n, MAX_RANK)
    if name == "svgd":
        return algo._create(n)
    return [algo.push_dist.p_create(opt) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_one_capture_per_spec_per_fused_run(name):
    stub = Counting()
    algo = _algo(name, stub)
    cache = algo.push_dist.runtime.cache
    opt = adam(LR)
    pids, losses = algo.bayes_infer(_loader(), 2, num_particles=2,
                                    **_infer_kw(name, opt))
    want = ALGOS[name][1]
    calls = 6 + (1 if name == "multiswag" else 0)     # + one collection
    assert stub.captured == want and stub.calls == calls
    assert cache.snapshot_stats()["misses"] == len(want)
    assert len(losses) == 2
    # a second fused run on the same particles: one hit per spec
    algo._fused_epochs(pids, _loader(), 2, **_fused_kw(name, opt))
    st = cache.snapshot_stats()
    assert stub.captured == want and stub.calls == 2 * calls
    assert (st["misses"], st["hits"]) == (len(want), len(want))
    # a second bayes_infer on the same store: the old particles freed,
    # the new ones take their slots, so every address and shape holds
    for pid in pids:
        algo.store.unregister(pid)
    algo.bayes_infer(_loader(), 2, num_particles=2, **_infer_kw(name, opt))
    assert stub.captured == want
    assert cache.snapshot_stats()["misses"] == len(want)
    # the store grows (capacity 2 -> 4): new tensors, every spec misses
    pids = algo.store.pids + _new_particles(algo, name, opt, 1)
    assert algo.store.capacity == 4
    algo._fused_epochs(pids, _loader(), 2, **_fused_kw(name, opt))
    assert stub.captured == want + want
    # the predict: one capture, a hit on the next call
    batch = _batch(seed=3)
    first = algo.posterior_pred(batch)
    assert torch.equal(algo.posterior_pred(batch), first)
    assert stub.captured[2 * len(want):] == ["ensemble_predict"]


class WarmUpFirst:
    """Capture's contract on the CPU: the body runs once when the program
    is made (the warm-up, which is the first call's execution), and the
    program's first call returns the warm-up's outputs only when it gets
    the very same argument objects; every other call runs the body."""

    def __call__(self, spec, args, cache_key=None):
        prog = eager(spec, args, cache_key)
        first = [(tuple(args), prog(*args))]

        def run(*call_args):
            if first:
                warm_args, out = first.pop()
                if all(a is b for a, b in zip(call_args, warm_args)):
                    return out
            return prog(*call_args)

        return Program(spec.name, cache_key, prog.num_particles, fn=run,
                       in_kinds=spec.in_kinds)


STATE_KEYS = {"ensemble": ("params", "opt_state"), "svgd": ("params",),
              "multiswag": ("params", "opt_state", "swag")}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_the_first_batch_is_trained_once(name):
    """N steps of a fused run through a program whose warm-up is its
    first call equal N steps of the eager body, bit for bit."""
    got = {}
    for mode, capturer in (("warm", WarmUpFirst()), ("eager", eager)):
        algo = _algo(name, capturer)
        _, losses = algo.bayes_infer(_loader(), 2, num_particles=P,
                                     **_infer_kw(name, adam(LR)))
        got[mode] = ([algo.store.stacked(k) for k in STATE_KEYS[name]],
                     losses)
    for a, b in zip(tree_leaves(got["warm"][0]), tree_leaves(got["eager"][0])):
        assert torch.equal(a, b)
    assert got["warm"][1] == got["eager"][1]


@pytest.mark.parametrize("model", [1, 2], ids=["data4", "data2xmodel2"])
@pytest.mark.parametrize("name", sorted(ALGOS))
def test_the_first_batch_is_trained_once_on_a_mesh(name, model):
    """The same on a store split over 4 CPU positions (particles only,
    and data 2 x model 2): every position's program answers its first
    call from its warm-up, so a step object that wraps the store's
    shards anew for a call (SteinVGD's groups of one) must hand the
    programs the objects they were captured with."""
    from repro_torch.core.store import Placement
    from repro_torch.launch import make_bench_mesh
    got = {}
    for mode, capturer in (("warm", WarmUpFirst()), ("eager", eager)):
        algo = ALGOS[name][0](MODULE, seed=0, backend="compiled",
                              device="cpu", placement=Placement(
                                  mesh=make_bench_mesh(4, model=model,
                                                       devices=["cpu"] * 4)))
        algo.push_dist.runtime.cache = ProgramCache(capturer=capturer)
        _, losses = algo.bayes_infer(_loader(), 2, num_particles=4,
                                     **_infer_kw(name, adam(LR)))
        got[mode] = ([algo.p_parameters()], losses)
    for a, b in zip(tree_leaves(got["warm"][0]), tree_leaves(got["eager"][0])):
        assert torch.equal(a, b)
    assert got["warm"][1] == got["eager"][1]


def test_a_new_batch_object_runs_the_step_again():
    """The check above has teeth: a first call with a copy of the batch
    (what converting the batch twice gives) steps the state a second
    time."""
    spec, args = _case("ensemble-sgd", masked=True)
    params = args[0]
    before = tree_map(torch.clone, params)
    prog = WarmUpFirst()(spec, args)
    after_warm_up = tree_map(torch.clone, params)
    prog(*args[:2], dict(args[2]), args[3])
    assert not torch.equal(tree_leaves(before)[0],
                           tree_leaves(after_warm_up)[0])
    assert not torch.equal(tree_leaves(params)[0],
                           tree_leaves(after_warm_up)[0])
