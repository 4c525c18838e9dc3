"""The port's ParticleStore against the reference's, on the CPU: the
round trips and pid-subset views of ``tests/test_store.py`` (view
write-back, commit, checkout ownership, growth, the subset round trip,
bad pids and counts), each run on both stores with the same numpy rows,
and the ``Infer`` subset runs that a second ``bayes_infer`` on one PD
makes (DeepEnsemble, MultiSWAG, SteinVGD on the compiled backend),
against the reference's on the same particles.

A subset checkout is a fresh dense stack and its commit writes dirty rows
that the next flush copies in place, so the canonical tensors keep their
addresses through a subset run: the full-live-set steps captured before
it are not captured again.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bdl import DeepEnsemble as JDeepEnsemble
from repro.bdl import MultiSWAG as JMultiSWAG
from repro.bdl import SteinVGD as JSteinVGD
from repro.core import ParticleStore as JParticleStore
from repro.optim import sgd as jsgd
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.core import ParticleStore
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import sgd
from repro_torch.runtime import ProgramCache
from test_torch_lifecycle import _batch, _inits, _jb, _max_diff, _modules, _np


def _rows(seed, shapes):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _stores():
    """(reference store, port store on the CPU, row converters)."""
    return ((JParticleStore(), lambda t: {k: jnp.asarray(v)
                                          for k, v in t.items()}),
            (ParticleStore(device="cpu"),
             lambda t: {k: torch.from_numpy(v.copy()) for k, v in t.items()}))


def _eq(tree, rows):
    return all(np.array_equal(np.asarray(tree[k]), rows[k]) for k in rows)


def _row(st, i):
    return {k: np.asarray(v)[i] for k, v in st.items()}


def test_store_view_writeback_roundtrip():
    trees = [_rows(i, [(3, 2), (4,)]) for i in range(3)]
    new_row = _rows(99, [(3, 2), (4,)])
    for store, conv in _stores():
        for pid, t in enumerate(trees):
            store.register(pid)
            store.write("params", pid, conv(t))
        assert store.capacity == 4        # 3 live -> power-of-two 4
        st = store.stacked("params")
        assert tuple(st["p0"].shape) == (4, 3, 2)
        assert np.allclose(np.asarray(store.active_mask()), [1, 1, 1, 0])
        for pid, t in enumerate(trees):
            assert _eq(store.read("params", pid), t)
        store.write("params", 1, conv(new_row))
        st2 = store.stacked("params")
        assert _eq(_row(st2, 1), new_row) and _eq(_row(st2, 0), trees[0])


def test_store_commit_replaces_views():
    for store, conv in _stores():
        for pid in range(2):
            store.register(pid)
            store.write("params", pid, conv(_rows(pid, [(2, 2)])))
        store.stacked("params")
        store.read("params", 0)
        fresh = {"p0": np.stack([_rows(7, [(2, 2)])["p0"],
                                 _rows(8, [(2, 2)])["p0"]])}
        stacks = store.snapshot_stats()["stacks"]
        store.commit("params", conv(fresh))
        assert _eq(store.read("params", 0), _rows(7, [(2, 2)]))
        assert _eq(store.read("params", 1), _rows(8, [(2, 2)]))
        assert store.snapshot_stats()["stacks"] == stacks   # no restack


def test_store_checkout_transfers_ownership():
    for store, conv in _stores():
        store.register(0)
        store.write("params", 0, conv(_rows(0, [(2,)])))
        st = store.checkout("params")
        with pytest.raises(KeyError):
            store.read("params", 0)
        store.commit("params", st)
        assert _eq(store.read("params", 0), _rows(0, [(2,)]))


def test_store_grows_with_new_particles():
    for store, conv in _stores():
        for pid in range(2):
            store.register(pid)
            store.write("params", pid, conv(_rows(pid, [(2,)])))
        assert store.stacked("params")["p0"].shape[0] == 2
        gen = store.generation()
        store.register(2)               # capacity 2 -> 4: a shape change
        store.write("params", 2, conv(_rows(2, [(2,)])))
        st = store.stacked("params")
        assert store.generation() > gen
        assert st["p0"].shape[0] == 4
        assert _eq(_row(st, 2), _rows(2, [(2,)]))


def test_store_subset_roundtrip():
    """An ordered subset (any order) stacks, checks out and commits
    without disturbing the other particles; the port keeps the canonical
    tensors (and their addresses) throughout."""
    trees = {pid: _rows(pid, [(2, 3)]) for pid in range(4)}
    for store, conv in _stores():
        for pid in range(4):
            store.register(pid)
            store.write("params", pid, conv(trees[pid]))
        full = store.stacked("params")
        ptrs = ([x.data_ptr() for x in tree_leaves(full)]
                if isinstance(store, ParticleStore) else None)
        sub = store.stacked("params", [3, 1])      # reordered subset read
        assert _eq(_row(sub, 0), trees[3]) and _eq(_row(sub, 1), trees[1])
        assert _eq(_row(store.dense("params", [2, 0]), 0), trees[2])
        st = store.checkout("params", [2, 3])
        store.commit("params", {k: v + 1.0 for k, v in st.items()}, [2, 3])
        assert _eq(store.read("params", 0), trees[0])   # untouched rows
        assert _eq(store.read("params", 2),
                   {k: v + 1.0 for k, v in trees[2].items()})
        full = store.stacked("params")
        assert _eq(_row(full, 3), {k: v + 1.0 for k, v in trees[3].items()})
        if ptrs is not None:
            assert [x.data_ptr() for x in tree_leaves(full)] == ptrs
        # the full live set in slot order is the canonical path itself
        assert store.stacked("params", [0, 1, 2, 3]) is full


def test_store_rejects_bad_pids_and_counts():
    for store, conv in _stores():
        for pid in (0, 1):
            store.register(pid)
            store.write("params", pid, conv(_rows(pid, [(2,)])))
        with pytest.raises(KeyError):
            store.stacked("params", [0, 7])          # unregistered pid
        with pytest.raises(KeyError):
            store.checkout("params", [7])
        with pytest.raises(ValueError):
            store.commit("params", conv({"p0": _rows(0, [(1, 2)])["p0"]}))
        with pytest.raises(ValueError):
            store.commit("params", conv({"p0": _rows(0, [(3, 2)])["p0"]}),
                         [0, 1])                     # wrong row count


@pytest.mark.parametrize("pid_list", [False, True])
def test_dense_raises_for_a_pid_without_the_key(pid_list):
    """Fault F1: a particle created in a killed particle's slot, holding
    only "params", has no "swag" row, though the killed particle's stale
    row is still stacked there. ``dense("swag")`` (all live pids, or a
    pid list naming it) raises KeyError in both stores, as the
    reference's ``read`` does; the pids that hold the key still read."""
    shapes = [(3, 2), (4,)]
    for store, conv in (
            (JParticleStore(capacity=2),
             lambda t: {k: jnp.asarray(v) for k, v in t.items()}),
            (ParticleStore(capacity=2, device="cpu"),
             lambda t: {k: torch.from_numpy(v.copy())
                        for k, v in t.items()})):
        for pid in (0, 1):
            store.register(pid)
            store.write("params", pid, conv(_rows(pid, shapes)))
            store.write("swag", pid, conv(_rows(10 + pid, shapes)))
        store.stacked("swag")
        store.unregister(1)
        store.register(2)
        store.write("params", 2, conv(_rows(2, shapes)))
        assert store.slot_of(2) == 1        # the killed particle's slot
        with pytest.raises(KeyError, match="for particle 2"):
            store.dense("swag", [0, 2] if pid_list else None)
        assert _eq(_row(store.dense("swag", [0]), 0), _rows(10, shapes))
        assert _eq(_row(store.dense("params"), 1), _rows(2, shapes))


def test_store_discard_and_keys():
    for store, conv in _stores():
        store.register(0)
        store.write("params", 0, conv(_rows(0, [(2,)])))
        store.write("scratch", 0, conv(_rows(1, [(2,)])))
        assert store.keys() == ["params", "scratch"]
        store.discard("scratch", 0)
        with pytest.raises(KeyError):
            store.read("scratch", 0)
        store.stacked("params")
        with pytest.raises(ValueError):
            store.discard("params", 0)               # stacked: refused


ALGOS = {
    "ensemble": (DeepEnsemble, JDeepEnsemble,
                 lambda opt: {"optimizer": opt(0.05)}),
    "multiswag": (MultiSWAG, JMultiSWAG,
                  lambda opt: {"optimizer": opt(0.05), "max_rank": 3}),
    "svgd": (SteinVGD, JSteinVGD, lambda opt: {"lr": 0.05}),
}


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_repeated_bayes_infer_runs_the_new_subset(algo):
    """A second ``bayes_infer`` on one compiled PD creates new particles
    and trains just those (a pid-subset run: a dense checkout under an
    all-ones mask); the first run's particles are left as they were.
    Params and ``posterior_pred`` match the reference's within 1e-5; the
    full-live-set step captured before keeps its program after the
    subset run."""
    cls, jcls, kw = ALGOS[algo]
    jmod, tmod = _modules(_inits(4))
    data = [_batch(8, s) for s in (3, 4)]
    jdata = [_jb(b) for b in data]
    with cls(tmod, backend="compiled", device="cpu") as tal, \
            jcls(jmod, num_devices=1, backend="compiled") as jal:
        pd = tal.push_dist
        pd.runtime.cache = ProgramCache()
        first, _ = tal.bayes_infer(data, 2, num_particles=2, **kw(sgd))
        jal.bayes_infer(jdata, 2, num_particles=2, **kw(jsgd))
        kept = {p: {k: v.clone() for k, v in pd.p_params(p).items()}
                for p in first}
        pids, losses = tal.bayes_infer(data, 2, num_particles=2, **kw(sgd))
        jpids, jlosses = jal.bayes_infer(jdata, 2, num_particles=2,
                                         **kw(jsgd))
        assert pids == jpids == [2, 3]
        assert np.abs(np.asarray(losses) - np.asarray(jlosses)).max() < 1e-5
        for p in first:
            assert all(torch.equal(pd.p_params(p)[k], kept[p][k])
                       for k in kept[p])
        for p in pd.particle_ids():
            assert _max_diff(_np(pd.p_params(p)),
                             jal.push_dist.p_params(p)) < 1e-5
        got = tal.posterior_pred(data[0]).numpy()
        assert np.abs(got - np.asarray(jal.posterior_pred(jdata[0]))).max() \
            < 1e-5
        if algo == "ensemble":
            # the full live set again: a program for this optimizer, once
            opt = sgd(0.05)
            tal._fused_epochs(pd.particle_ids(), data, 1, optimizer=opt)
            misses = pd.runtime.cache.snapshot_stats()["misses"]
            tal._fused_epochs(pids, data, 1, optimizer=opt)      # a subset
            tal._fused_epochs(pd.particle_ids(), data, 1, optimizer=opt)
            # the subset run looked its step up on its own dense stack;
            # the full run after it found its program
            assert pd.runtime.cache.snapshot_stats()["misses"] == misses + 1
