"""The port's actor runtime on the CPU: the NEL (``repro_torch.core.nel``),
particles and the ``backend="nel"`` algorithms, against the port's own
compiled path and against the reference's NEL.

At the tiny ViT of ``tests/test_torch_train.py`` (2 layers, d_model 64;
its ``_numpy_inits`` / ``_modules`` hand both packages the same
particles), 2 epochs x 2 batches with ``sgd``:

  * the port's NEL against the port's compiled path for DeepEnsemble,
    MultiSWAG (moments and ranks too) and SteinVGD (ell = 1 and the
    median heuristic): params and ``posterior_pred`` within 1e-4, the
    bound of ``tests/test_executor.py:281-312`` (DESIGN.md §3);
  * the port's NEL against the reference's ``backend="nel"`` on shared
    inits, for the same algorithms: losses and params within 1e-4;
  * the NEL's registry (register / unregister / rebalance, a dead pid's
    KeyError), its LRU swap counts against the reference NEL's on one
    dispatch sequence, the CompiledRuntime's fallback to ``_nel_infer``,
    and the refusals of several GPUs and of host offload.

Every run that could hang goes through ``_bounded``: a deadlock fails the
test instead of stalling the suite.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import SteinVGD as JSteinVGD
from repro.core.nel import NodeEventLoop as JNodeEventLoop
from repro.data import DataLoader as JDataLoader
from repro.optim import sgd as jsgd
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.bdl.infer import Infer
from repro_torch.core import PushDistribution
from repro_torch.core.nel import NodeEventLoop
from repro_torch.core.tree import tree_flatten
from repro_torch.data import DataLoader
from repro_torch.optim import sgd
from test_torch_train import _cfgs, _flat_jax, _flat_torch, _modules, \
    _numpy_inits

N, EPOCHS, LR = 4, 2, 0.05
T = 300.0       # seconds a whole training run may take before it fails

ALGOS = {
    "ensemble": (DeepEnsemble, JDeepEnsemble,
                 lambda opt: {"optimizer": opt(LR)}),
    "multiswag": (MultiSWAG, JMultiSWAG,
                  lambda opt: {"optimizer": opt(LR), "max_rank": 3,
                               "pretrain_epochs": 1}),
    "svgd-ell1": (SteinVGD, JSteinVGD,
                  lambda opt: {"lr": LR, "lengthscale": 1.0}),
    "svgd-median": (SteinVGD, JSteinVGD,
                    lambda opt: {"lr": LR, "lengthscale": 0.0}),
}


def _bounded(fn, *args, **kw):
    """``fn(*args, **kw)`` on a thread joined within T seconds."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:      # handed to the test below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(T)
    assert not t.is_alive(), f"{fn} did not finish within {T} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _image_batch(cfg):
    return next(iter(DataLoader(cfg, batch_size=6, num_batches=1, seed=9)))


def _port_run(name, backend, inits):
    """One port run of ``name`` from ``inits``: (algo, pids, losses)."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, inits)
    cls, _, kw = ALGOS[name]
    algo = cls(tmod, backend=backend, device="cpu")
    pids, losses = _bounded(
        algo.bayes_infer, DataLoader(tcfg, batch_size=8, num_batches=2,
                                     seed=0), EPOCHS, num_particles=N,
        **kw(sgd))
    return algo, pids, losses


def _swag_rows(algo, pids):
    """Each particle's SWAG moments (mean, sq_mean leaves) and rank."""
    out = []
    for pid in pids:
        st = algo.push_dist.particles[pid].state["swag"]
        leaves = [x.numpy().copy() for key in ("mean", "sq_mean")
                  for x in tree_flatten(st[key], sort_keys=True)[0]]
        out.append((leaves, int(st["rank"]), float(st["n"])))
    return out


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_nel_matches_compiled_on_the_port(name):
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(jcfg, N)
    runs = {b: _port_run(name, b, inits) for b in ("nel", "compiled")}
    (nel, npids, nloss), (comp, cpids, closs) = runs["nel"], \
        runs["compiled"]
    try:
        assert nel.backend == "nel" and comp.backend == "compiled"
        assert np.abs(np.array(nloss) - np.array(closs)).max() < 1e-4
        for a, b in zip(nel.p_parameters(), comp.p_parameters()):
            assert np.abs(_flat_torch(a) - _flat_torch(b)).max() < 1e-4
        batch = _image_batch(tcfg)
        got = _bounded(nel.posterior_pred, batch)
        want = comp.posterior_pred(batch)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() < 1e-4
        if name == "multiswag":
            for (ln, rn, nn), (lc, rc, nc) in zip(_swag_rows(nel, npids),
                                                  _swag_rows(comp, cpids)):
                assert rn == rc == EPOCHS - 1 and nn == nc
                for a, b in zip(ln, lc):
                    assert np.abs(a - b).max() < 1e-4
        # the NEL run's hops: one per particle per step (SVGD: the
        # leader protocol's), none left in flight
        st = nel.push_dist.stats()
        ex = st["executor"]
        assert ex["completed"] == ex["dispatched"] == \
            st["dispatch"]["dispatches"]
        steps = EPOCHS * 2
        if name.startswith("svgd"):
            per_step = 5 * (N - 1) + 2     # steps, gets, follows
            assert st["dispatch"]["dispatches"] == 1 + steps * per_step + N
            assert ex["pool_dispatched"] == steps * (N - 1)
        else:
            collects = (EPOCHS - 1) * N if name == "multiswag" else 0
            assert st["dispatch"]["dispatches"] == steps * N + collects + N
        assert st["dispatch"]["xdev_transfers"] == 0
    finally:
        nel.cleanup()
        comp.cleanup()


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_nel_matches_the_reference_nel(name):
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(jcfg, N)
    jmod, _ = _modules(jcfg, tcfg, inits)
    _, jcls, kw = ALGOS[name]
    jalgo = jcls(jmod, backend="nel", num_devices=1)
    try:
        jpids, jloss = jalgo.bayes_infer(
            JDataLoader(jcfg, batch_size=8, num_batches=2, seed=0), EPOCHS,
            num_particles=N, **kw(jsgd))
        jparams = jalgo.p_parameters()
        jswag = [jalgo.push_dist.particles[p].state.get("swag")
                 for p in jpids]
    finally:
        jalgo.cleanup()
    talgo, tpids, tloss = _port_run(name, "nel", inits)
    try:
        assert len(tloss) == len(jloss) == N
        assert np.abs(np.array(tloss) - np.array(jloss)).max() < 1e-4
        for jp, tp in zip(jparams, talgo.p_parameters()):
            assert np.abs(_flat_torch(tp) - _flat_jax(jp)).max() < 1e-4
        if name == "multiswag":
            for js, (leaves, rank, n) in zip(jswag,
                                             _swag_rows(talgo, tpids)):
                assert rank == int(js["rank"]) and n == float(js["n"])
                want = [np.asarray(x) for key in ("mean", "sq_mean")
                        for x in jax.tree.leaves(js[key])]
                for a, b in zip(leaves, want):
                    assert np.abs(a - b).max() < 1e-4
        jstats = set(jalgo.push_dist.nel.executor.stats())
        assert set(talgo.push_dist.stats()["executor"]) == jstats
    finally:
        talgo.cleanup()


# ---------------------------------------------------------------------------
# the NEL itself
# ---------------------------------------------------------------------------

def _where():
    return threading.current_thread().name


def test_nel_register_unregister_rebalance():
    nel = NodeEventLoop(num_devices=3, cache_size=8, device="cpu")
    try:
        pids = [nel.register(object(), device=0) for _ in range(5)]
        assert pids == list(range(5))
        assert [nel.dispatch(p, _where, needs_device=True).wait(10)
                for p in pids] == ["push-dev0"] * 5
        moves = nel.rebalance()
        assert moves == {1: (0, 1), 2: (0, 2), 4: (0, 1)}
        assert [nel.dispatch(p, _where, needs_device=True).wait(10)
                for p in pids] == [f"push-dev{i % 3}" for i in range(5)]
        assert nel.device_of(4) == torch.device("cpu")
        nel.unregister(2)
        assert nel.particle_ids() == [0, 1, 3, 4]
        with pytest.raises(KeyError):
            nel.dispatch(2, _where)
        with pytest.raises(KeyError):
            nel.dispatch(2, _where, lightweight=True)
        with pytest.raises(KeyError):
            nel.unregister(2)
        # rebalance after the churn: pid order 0, 1, 3, 4 -> devs 0, 1, 2, 0
        assert nel.rebalance() == {3: (0, 2), 4: (1, 0)}
        assert nel.stats["dispatches"] == 10
    finally:
        nel.shutdown()


def test_nel_lru_swaps_match_the_reference():
    """The same dispatch sequence, cache_size below the particle count:
    the port's LRU active set swaps in and out as the reference's does;
    lightweight and non-device hops do not touch it."""
    seq = [0, 1, 2, 0, 3, 1, 1, 2, 4, 0, 3, 3, 2, 4, 1, 0]
    counts = []
    for make in (lambda: JNodeEventLoop(num_devices=1, cache_size=2),
                 lambda: NodeEventLoop(num_devices=1, cache_size=2,
                                       device="cpu")):
        nel = make()
        try:
            for _ in range(5):
                nel.register(None)
            for i, pid in enumerate(seq):
                nel.dispatch(pid, lambda: None, needs_device=True).wait(10)
                nel.dispatch(pid, lambda: None,
                             lightweight=bool(i % 2)).wait(10)
            nel.drain(10)
            counts.append(dict(nel.stats))
        finally:
            nel.shutdown()
    assert counts[0] == counts[1]
    assert counts[1]["swaps_out"] > 0
    assert counts[1]["swaps_in"] == counts[1]["swaps_out"] + 2


def test_compiled_runtime_falls_back_to_nel():
    """An Infer subclass without _fused_infer runs the NEL path under
    backend="compiled"."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, 1))

    class NelOnly(Infer):
        def _nel_infer(self, dataloader, epochs, **kw):
            return "nel-path"

    with NelOnly(tmod, backend="compiled", device="cpu") as alg:
        assert not alg._has_fused()
        assert alg.bayes_infer(None, 1) == "nel-path"
    with DeepEnsemble(tmod, backend="compiled", device="cpu") as alg:
        assert alg._has_fused()


def test_several_gpus_and_offload_refused():
    """Since the particle axis was ported (queue 1 item 10), a NEL over
    several GPUs and host offload are no longer refused: a request past
    the visible CUDA devices raises the reference's ValueError before any
    worker or store exists, and ``offload=True`` builds a PD whose store
    keeps rows where the NEL puts them."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, 1))
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 2} devices but "
                                         f"only {n} present"):
        PushDistribution(tmod, num_devices=n + 2, device="cuda")
    with pytest.raises(ValueError, match="present"):
        NodeEventLoop(num_devices=n + 4, device="cuda:0")
    with pytest.raises(ValueError, match="present"):
        SteinVGD(tmod, num_devices=n + 2, device="cuda")
    with PushDistribution(tmod, offload=True, device="cpu") as pd:
        assert pd.nel.offload and pd.store.keep_row_devices
