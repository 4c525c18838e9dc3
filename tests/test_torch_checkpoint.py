"""The port's checkpoints against the JAX package, on the CPU: the
checkpoint tests of ``tests/test_substrate.py``, ``tests/test_serve.py``,
``tests/test_lifecycle.py`` and ``tests/test_precision.py`` on the port,
and the files both ways:

  * ``save`` writes the reference's paths for the same tree, and each
    package's ``restore(like=)`` reads the other's file with equal bytes
    (params and the ``opt_state`` of ``sgd`` with momentum and of
    ``adam``);
  * a store the reference's ``save_store`` wrote is restored by the
    port's ``restore_store``, and a store the port wrote by the
    reference's, with equal bytes key by key (an fp32 and a bf16 store,
    trained a step: params, grads, ``sgd`` and ``adam`` state), the same
    pids, capacity, mask and precision;
  * the port's own round trips: a store restored at capacities 4, 8 and
    2 serves the same BMA, bf16 comes back exact, ``precision=`` re-casts
    both ways, an explicit missing key raises.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro_torch import checkpoint
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.store import ParticleStore
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.optim import adam, sgd
from repro_torch.serve import PredictiveEngine


def _inits(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((3, 4)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(4) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _tfwd(p, b):
    return torch.einsum("bi,pio->pbo", b[0].to(p["w"].dtype), p["w"]) \
        + p["b"][:, None]


def _tloss(p, b):
    return ((_tfwd(p, b) - b[1]) ** 2).mean((1, 2)), {}


def _modules(inits):
    """The linear module of tests/test_lifecycle.py in both packages,
    each init handing out ``inits`` in order."""
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: (jnp.mean((b[0] @ p["w"] + p["b"]
                                           - b[1]) ** 2), {}),
                   lambda p, b: b[0] @ p["w"] + p["b"])
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)), _tloss,
                          _tfwd)
    return jmod, tmod


def _batch(seed=4):
    x = np.random.default_rng(seed).standard_normal((5, 3)).astype(np.float32)
    return x, (x @ np.ones((3, 4), np.float32)).astype(np.float32)


def _np(tree):
    """A tree of either package as numpy, leaf order by key path."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
            else np.asarray(x)
    return {jax.tree_util.keystr(path): conv(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(a, b):
    na, nb = _np(a), _np(b)
    assert set(na) == set(nb)
    for k in na:
        assert na[k].dtype == nb[k].dtype and na[k].shape == nb[k].shape, k
        assert np.array_equal(na[k], nb[k]), k


def _tdtype(tree):
    return {str(x.dtype) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """tests/test_substrate.py::test_checkpoint_roundtrip on the port."""
    tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)},
            "c": torch.tensor(7)}
    d = str(tmp_path / "ck")
    checkpoint.save(d, 3, tree)
    checkpoint.save(d, 7, tree_map(lambda x: x + 1, tree))
    assert checkpoint.latest_step(d) == 7
    step, restored = checkpoint.restore(d, like=tree)
    assert step == 7
    assert torch.equal(restored["a"]["b"], tree["a"]["b"] + 1)
    step3, r3 = checkpoint.restore(d, step=3, like=tree)
    assert step3 == 3 and torch.equal(r3["c"], tree["c"])
    assert r3["c"].dtype == torch.int64
    _, flat = checkpoint.restore(d, device="cpu")
    assert set(flat) == {"['a']['b']", "['c']"}
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"))


def _opt_tree(jopt):
    """A stacked params tree and the reference's optimizer state, one step
    taken (sgd with momentum, or adam)."""
    p = {k: np.stack([i[k] for i in _inits(3)]) for k in ("w", "b")}
    p["units"] = (np.ones((3, 2, 2), np.float32), [np.zeros((3, 1),
                                                            np.float32)])
    g = tree_map(lambda a: np.full_like(a, 0.5), p)
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jax.vmap(jopt.init)(jp)
    jp, jstate = jax.vmap(jopt.update)(jp, jax.tree.map(jnp.asarray, g),
                                       jstate)
    return {"params": jp, "opt": jstate}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_files_cross_both_ways(tmp_path, opt):
    """The same tree saved by each package: the same paths in the same
    order and equal leaves; each package's ``restore(like=)`` reads the
    other's file to equal bytes."""
    jopt = jsgd(0.1, momentum=0.9) if opt == "sgd" else jadam(1e-2)
    jtree = _opt_tree(jopt)
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree))
    jckpt.save(str(tmp_path / "j"), 5, jtree)
    checkpoint.save(str(tmp_path / "t"), 5, ttree)
    jz = np.load(tmp_path / "j" / "ckpt_00000005.npz")
    tz = np.load(tmp_path / "t" / "ckpt_00000005.npz")
    assert str(jz["__manifest__"]) == str(tz["__manifest__"])
    assert sorted(jz.files) == sorted(tz.files)
    for f in jz.files:
        if f != "__manifest__":
            assert jz[f].dtype == tz[f].dtype and np.array_equal(jz[f],
                                                                 tz[f]), f
    assert checkpoint.leaf_paths(ttree) == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    # the port reads the reference's file, the reference the port's
    _, got = checkpoint.restore(str(tmp_path / "j"), like=ttree)
    _same(got, ttree)
    _, jgot = jckpt.restore(str(tmp_path / "t"), like=jtree)
    _same(jgot, jtree)


def test_restore_like_takes_each_leafs_dtype(tmp_path):
    tree = {"w": torch.randn(3, 2).to(torch.bfloat16),
            "s": torch.zeros((), dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 1, tree)
    z = np.load(tmp_path / "ckpt_00000001.npz")
    assert z["leaf_1"].dtype == np.float32          # bf16 widened on disk
    _, got = checkpoint.restore(str(tmp_path), like=tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    assert got["s"].dtype == torch.int32
    # the reference reads it into its own bf16 tree, exactly
    jlike = {"w": jnp.zeros((3, 2), jnp.bfloat16), "s": jnp.int32(0)}
    _, jgot = jckpt.restore(str(tmp_path), like=jlike)
    assert np.array_equal(np.asarray(jgot["w"], np.float32),
                          tree["w"].float().numpy())
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), like={"nope": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the store handoff, both ways
# ---------------------------------------------------------------------------

def _pds(opt, precision=None, n=3, capacity=4):
    """Both packages' PDs on the same inits, ``n`` particles, one NEL step
    each (so opt_state and grads hold data), then a kill of particle 1: a
    hole in the slot layout."""
    jmod, tmod = _modules(_inits(n))
    jpd = JPD(jmod, num_devices=1, capacity=capacity, precision=precision)
    tpd = PushDistribution(tmod, capacity=capacity, precision=precision,
                           device="cpu")
    jo = jsgd(0.1, momentum=0.9) if opt == "sgd" else jadam(1e-2)
    to = sgd(0.1, momentum=0.9) if opt == "sgd" else adam(1e-2)
    x, y = _batch()
    for _ in range(n):
        jpd.p_create(jo)
        tpd.p_create(to)
    for p in jpd.particles.values():
        p.step((jnp.asarray(x), jnp.asarray(y))).wait()
    for p in tpd.particles.values():
        p.step((torch.from_numpy(x), torch.from_numpy(y))).wait()
    jpd.drain()
    tpd.drain()
    jpd.p_kill(1)
    tpd.p_kill(1)
    return jpd, tpd


def _store_rows(store, key):
    return {p: store.read(key, p) for p in store.pids}


@pytest.mark.parametrize("opt,precision", [("sgd", None), ("adam", None),
                                           ("adam", "bf16")])
def test_store_files_cross_both_ways(tmp_path, opt, precision):
    jpd, tpd = _pds(opt, precision)
    try:
        jckpt.save_store(str(tmp_path / "j"), 3, jpd.store)
        checkpoint.save_store(str(tmp_path / "t"), 3, tpd.store)
        # the port restores the reference's store, the reference the port's
        _, t2 = checkpoint.restore_store(str(tmp_path / "j"), device="cpu")
        _, j2 = jckpt.restore_store(str(tmp_path / "t"))
        # both restores seat the live pids in their saved order from slot 0
        assert t2.active_mask().tolist() == \
            np.asarray(j2.active_mask()).tolist() == [1, 1, 0, 0]
        for restored, src in ((t2, jpd.store), (j2, tpd.store)):
            assert restored.pids == src.pids == [0, 2]
            assert restored.capacity == src.capacity == 4
            assert restored.precision.describe() == src.precision.describe()
            for key in ("params", "opt_state", "grads"):
                want, got = _store_rows(src, key), _store_rows(restored, key)
                for p in src.pids:
                    _same(got[p], want[p])
        if precision == "bf16":
            assert _tdtype(t2.read("params", 0)) == {"torch.bfloat16"}
    finally:
        jpd.cleanup()
        tpd.cleanup()


def test_store_checkpoint_roundtrip(tmp_path):
    """tests/test_serve.py::test_store_checkpoint_roundtrip on the port."""
    _, tmod = _modules(_inits(3, seed=1))
    pd = PushDistribution(tmod, device="cpu")
    try:
        for _ in range(3):
            pd.p_create(sgd(0.1))
        x, y = _batch()
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        for p in pd.particles.values():
            p.step(batch).wait()
        pd.drain()
        path = checkpoint.save_store(str(tmp_path), 7, pd.store)
        assert os.path.basename(path) == "store_00000007.npz"
        step, store2 = checkpoint.restore_store(str(tmp_path), device="cpu")
        assert step == 7 and store2.pids == pd.store.pids
        for key in ("params", "opt_state"):
            _same(store2.stacked(key), pd.store.stacked(key))
        eng = PredictiveEngine(pd.module.forward, store=store2,
                               kind="regress")
        want = PredictiveEngine(pd.module.forward, store=pd.store,
                                kind="regress").predict(batch)
        assert torch.equal(eng.predict(batch)["mean"], want["mean"])
    finally:
        pd.cleanup()


def test_store_checkpoint_explicit_missing_key_raises(tmp_path):
    store = ParticleStore(device="cpu")
    store.register(0)
    store.write("params", 0, {"w": torch.ones(2)})
    with pytest.raises(KeyError):
        checkpoint.save_store(str(tmp_path), 0, store,
                              keys=["params", "nope"])


def test_checkpoint_roundtrip_across_capacities(tmp_path):
    """tests/test_lifecycle.py::test_checkpoint_roundtrip_across_capacities
    on the port: saved capacity, grown, shrink-to-fit (2 < 3 live -> 4)."""
    _, tmod = _modules(_inits(4))
    with PushDistribution(tmod, capacity=4, device="cpu") as pd:
        pids = [pd.p_create(sgd(0.1)) for _ in range(4)]
        pd.p_kill(pids[2])
        checkpoint.save_store(str(tmp_path), 1, pd.store)
        live = pd.store.pids
        x = torch.from_numpy(_batch(2)[0])
        for cap, want_cap in ((None, 4), (8, 8), (2, 4)):
            step, s2 = checkpoint.restore_store(str(tmp_path), capacity=cap,
                                                device="cpu")
            assert step == 1 and s2.pids == live
            assert s2.capacity == want_cap
            assert int(s2.active_mask().sum()) == 3
            for p in live:
                _same(s2.read("params", p), pd.store.read("params", p))
            heads = PredictiveEngine(pd.module.forward, store=s2,
                                     kind="regress").predict((x, None))
            ref = np.mean([(x @ pd.p_params(p)["w"] + pd.p_params(p)["b"])
                           .numpy() for p in live], 0)
            assert np.abs(heads["mean"].numpy() - ref).max() < 1e-5


def test_checkpoint_preserves_bf16_and_recasts_up(tmp_path):
    """tests/test_precision.py::test_checkpoint_preserves_bf16_and_recasts_up
    on the port."""
    _, tmod = _modules(_inits(3))
    with PushDistribution(tmod, capacity=4, precision="bf16",
                          device="cpu") as pd:
        pids = [pd.p_create(sgd(0.1)) for _ in range(3)]
        want = {p: tree_map(torch.clone, pd.p_params(p)) for p in pids}
        checkpoint.save_store(str(tmp_path), 1, pd.store)
    _, s2 = checkpoint.restore_store(str(tmp_path), device="cpu")
    assert s2.precision.master == torch.bfloat16
    for p in pids:
        got = s2.read("params", p)
        assert _tdtype(got) == {"torch.bfloat16"}
        _same(got, want[p])
    _, s3 = checkpoint.restore_store(str(tmp_path), precision="fp32",
                                     device="cpu")
    assert _tdtype(s3.read("params", pids[0])) == {"torch.float32"}


def test_checkpoint_recasts_fp32_down_to_bf16(tmp_path):
    """tests/test_precision.py::test_checkpoint_recasts_fp32_down_to_bf16
    on the port."""
    _, tmod = _modules(_inits(2))
    with PushDistribution(tmod, capacity=4, device="cpu") as pd:
        pids = [pd.p_create(sgd(0.1)) for _ in range(2)]
        want = {p: tree_map(torch.clone, pd.p_params(p)) for p in pids}
        checkpoint.save_store(str(tmp_path), 2, pd.store)
    _, s2 = checkpoint.restore_store(str(tmp_path), precision="bf16",
                                     device="cpu")
    assert s2.precision.master == torch.bfloat16
    for p in pids:
        got = s2.read("params", p)
        assert _tdtype(got) == {"torch.bfloat16"}
        _same(got, tree_map(lambda x: x.to(torch.bfloat16), want[p]))


def test_restore_store_keeps_kv_keys_at_kv_dtype(tmp_path):
    """``kv*`` keys follow the policy's ``kv_dtype``, never the master's;
    a key some particles lack comes back for the others only."""
    from repro_torch.core.precision import Precision
    store = ParticleStore(capacity=2, device="cpu")
    for pid in (0, 1):
        store.register(pid)
        store.write("params", pid, {"w": torch.ones(2)})
    store.write("kv_pages", 0, {"k": torch.ones(3)})
    checkpoint.save_store(str(tmp_path), 0, store)
    _, s2 = checkpoint.restore_store(
        str(tmp_path), device="cpu",
        precision=Precision(master_dtype="bfloat16",
                            compute_dtype="bfloat16", kv_dtype="float16"))
    assert s2.read("params", 1)["w"].dtype == torch.bfloat16
    assert s2.read("kv_pages", 0)["k"].dtype == torch.float16
    assert not s2.has("kv_pages", 1)
