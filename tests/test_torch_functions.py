"""Functions of ported modules that the port lacked (ROADMAP.md queue 1
item 16), each against the reference on the CPU:

  * ``core.functional.{init_stacked, stack_pytrees, unstack_pytree,
    masked_select}`` on a tiny ViT's trees, bit for bit;
  * ``DecodeScheduler.queue_depth()`` while the step lock holds the
    scheduler, and after it drained, equal to the reference's;
  * ``PredictiveEngine.stacked_params`` / ``active_mask`` over a store
    under churn, equal to the reference engine's;
  * the ``Runtime`` protocol: both backends satisfy it, as the
    reference's do;
  * ``configs.vit_mnist.table1_variant`` field for field;
  * ``Infer.placement`` (the store's plan; ``"auto"`` is ``mesh=None``
    with no CUDA device, as the reference's is on one device).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vit_mnist as jvit
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.core import functional as jfunctional
from repro.models import api as japi
from repro.runtime import backends as jbackends
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro.serve import serve_decode as jserve_decode
from repro_torch.bdl import DeepEnsemble
from repro_torch.configs import vit_mnist as tvit
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core import functional
from repro_torch.core.store import Placement
from repro_torch.interop import params_from_numpy
from repro_torch.runtime import Runtime
from repro_torch.runtime.backends import CompiledRuntime, NelRuntime
from repro_torch.serve import PredictiveEngine, serve_decode
from test_torch_lifecycle import _pds
from test_torch_speculative import _cfgs as _lm_cfgs
from test_torch_speculative import _jax_stacked, _port_pd
from test_torch_train import _cfgs, _flat_jax, _flat_torch, _numpy_inits


def test_stacking_helpers_match_the_reference():
    jcfg, tcfg = _cfgs()
    inits = _numpy_inits(jcfg, 3)
    trees = [params_from_numpy(t) for t in inits]
    jtrees = [jax.tree.map(jnp.asarray, t) for t in inits]
    st = functional.stack_pytrees(trees)
    jst = jfunctional.stack_pytrees(jtrees)
    assert _flat_torch(functional.unstack_pytree(st, 3)[2]).tolist() == \
        _flat_jax(jfunctional.unstack_pytree(jst, 3)[2]).tolist()
    rows = functional.unstack_pytree(st, 2)
    assert len(rows) == 2 and rows[1]["cls"].data_ptr() != \
        rows[0]["cls"].data_ptr()
    # init_stacked draws one init per particle from the generator, in order
    it = iter(trees)
    mod = ParticleModule(lambda g: next(it))
    got = functional.init_stacked(mod, 3, torch.Generator())
    for a, b in zip(jax.tree.leaves(jst), functional.tree_flatten(
            got, sort_keys=True)[0]):
        assert np.array_equal(np.asarray(a), b.numpy())
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    new = functional.tree_map(lambda x: x + 1.0, st)
    got = functional.masked_select(torch.from_numpy(mask), new, st)
    want = jfunctional.masked_select(jnp.asarray(mask), jax.tree.map(
        lambda x: x + 1.0, jst), jst)
    for a, b in zip(jax.tree.leaves(want), functional.tree_flatten(
            got, sort_keys=True)[0]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert torch.equal(got["cls"][1], st["cls"][1])     # out of place


def test_decode_queue_depth_matches_the_reference():
    jcfg, tcfg = _lm_cfgs()
    stacked = _jax_stacked(jcfg, 2)
    prompts = [[3, 5, 7], [2, 4], [9, 8, 7, 6]]
    tpd = _port_pd(tcfg, stacked)
    jmod = JModule(init=lambda r: japi.init_params(r, jcfg),
                   loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                   forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                   cfg=jcfg)
    depths = {}
    with JPD(jmod, num_devices=1, seed=0) as jpd:
        for i in range(2):
            jpd.p_create(params=jax.tree.map(lambda a, i=i: a[i], stacked))
        jsvc = jserve_decode(jpd, jcfg, num_pages=16, page_size=8,
                             max_active=1, decode_kernel=False,
                             warmup=False)
        tsvc = serve_decode(tpd, tcfg, num_pages=16, page_size=8,
                            max_active=1, warmup=False)
        try:
            for name, svc in (("ref", jsvc), ("port", tsvc)):
                sched = svc.scheduler
                assert sched.queue_depth() == 0
                with sched.step_lock:
                    futs = [svc.generate_async(p, max_new=2)
                            for p in prompts]
                    time.sleep(0.3)
                    held = sched.queue_depth()
                for f in futs:
                    f.result(60)
                depths[name] = (held, sched.queue_depth())
        finally:
            jsvc.close()
            tsvc.close()
            tpd.cleanup()
    assert depths["port"] == depths["ref"]
    assert depths["port"][1] == 0 and depths["port"][0] >= 2


def test_engine_stacked_params_and_mask_match_the_reference():
    jpd, tpd = _pds(3)
    with jpd, tpd:
        jeng = JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                 kind="regress")
        teng = PredictiveEngine(tpd.module.forward, store=tpd.store,
                                kind="regress")
        for pd in (jpd, tpd):
            pd.p_kill(1)
        assert teng.active_mask().tolist() == np.asarray(
            jeng.active_mask()).tolist()
        want, got = jeng.stacked_params(), teng.stacked_params()
        for k in ("w", "b"):
            live = [0, 2]
            assert np.abs(got[k].numpy()[live]
                          - np.asarray(want[k])[live]).max() == 0
        assert teng.stacked_params() is got        # cached between commits
        static = PredictiveEngine(tpd.module.forward, params=got)
        assert static.active_mask().tolist() == [1.0] * got["w"].shape[0]
        assert static.stacked_params() is got


def test_runtime_protocol_is_satisfied_by_both_backends():
    with PushDistribution(ParticleModule(init=None), device="cpu",
                          backend="compiled") as pd:
        assert isinstance(pd.runtime, Runtime)
        assert isinstance(NelRuntime(pd), Runtime)
        assert isinstance(CompiledRuntime(pd), Runtime)
    assert not isinstance(object(), Runtime)
    names = {n for n in dir(jbackends.Runtime) if not n.startswith("_")}
    assert names <= {n for n in dir(Runtime) if not n.startswith("_")}


@pytest.mark.parametrize("depth", [1, 6, 12])
def test_table1_variant_matches_the_reference(depth):
    j, t = jvit.table1_variant(depth), tvit.table1_variant(depth)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.name == f"vit-mnist-d{depth}" and t.d_model == 768


def test_infer_placement_is_the_stores_plan():
    with DeepEnsemble(ParticleModule(
            init=lambda g: {"w": torch.zeros(3, device=g.device)}),
            device="cpu", placement="auto") as algo:
        assert algo.placement == Placement() == algo.store.placement
        assert algo.push_dist.stats()["placement"]["mesh_shape"] is None

    # sized from the init's bytes: a particle past the memory budget
    # takes a model axis above 1
    from repro_torch.bdl import infer
    tree = infer._init_shapes(ParticleModule(
        init=lambda g: {"w": torch.zeros(1000, device=g.device),
                        "b": torch.zeros(10, dtype=torch.bfloat16)}))
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree.items()} == {
        "w": ((1000,), torch.float32), "b": ((10,), torch.bfloat16)}

    def refused(g):
        raise RuntimeError("an init that needs real memory")
    with pytest.raises(ValueError, match="pass a Placement"):
        DeepEnsemble(ParticleModule(init=refused), device="cpu",
                     placement="auto")
