"""The port's NEL over several devices with host offload, against the
reference's own 4-device run, on the CPU.

The reference runs in ONE subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_store.py`` runs its sharded checks): SteinVGD on the tiny ViT
of ``tests/test_torch_train.py`` (2 layers, d_model 64), 12 particles on a
NEL over 4 devices with ``cache_size=2`` and offload on, 2 epochs x 2
batches, its store on a 4-device ``data`` mesh, which it then saves. The
reference's NEL hands a tensor to a particle on another device as it is,
which jax refuses for committed arrays (``_svgd_leader`` stacks views
from four devices): the subprocess wraps the reference's
``Particle.get`` and ``send`` so that a crossing tensor is
``device_put`` onto the receiver's device, the rule the port applies at
its handler boundary; the counts, the schedule and the math stay the
reference's own. Its rows, left on four devices, cannot stack, and its
``save_store`` would skip the key: the subprocess fetches them to the
host and places the stack on its mesh before the save. The port runs the same program on a NEL over 4 logical CPU devices
(``devices=["cpu"] * 4``) with its store on a 4-position mesh of the CPU.
Held:

  * params and losses within 1e-4;
  * the NEL's ``dispatches``, ``swaps_in``, ``swaps_out`` and
    ``xdev_transfers`` equal to the reference's (the leader's schedule
    is deterministic: every hop count follows from the particle layout);
  * offload frees the rows: after the run no particle outside a device's
    active set holds params off the host, and the store keeps no stacked
    params;
  * the reference's saved mesh store restored onto the port's 4-position
    mesh, and the port's saved store restored by the reference, both to
    equal params, and the manifest's mesh shape and axes.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.bdl import SteinVGD
from repro_torch.checkpoint import restore_store, save_store
from repro_torch.core.store import Placement, Sharded
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataLoader
from repro_torch.launch import make_bench_mesh
from test_torch_nel import _bounded
from test_torch_train import _cfgs, _flat_torch, _modules, _numpy_inits

REPO = Path(__file__).resolve().parents[1]
N, EPOCHS, LR, CACHE = 12, 2, 0.05, 2

_REFERENCE = textwrap.dedent('''
    import json, sys
    import numpy as np
    import jax
    from jax.flatten_util import ravel_pytree
    sys.path.insert(0, sys.argv[2])
    from test_torch_train import _cfgs, _modules, _numpy_inits
    from repro.bdl import SteinVGD
    from repro.checkpoint import ckpt
    from repro.core.store import Placement
    from repro.data import DataLoader
    from repro.launch.mesh import make_bench_mesh
    from repro.core import particle as jparticle
    assert len(jax.devices()) == 4

    # a tensor crossing devices moves at the message boundary (see the
    # module doc): the reference's own get and send, plus the move
    def get(self, pid):
        target = self.nel.particle(pid)
        if self.nel._device_of[pid] != self.nel._device_of[self.pid]:
            self.nel._bump("xdev_transfers")
        here = self.nel.device_of(self.pid)

        def grab(_t):
            g = _t.state["grads"]
            return jparticle.ParticleView(
                pid, jax.device_put(jparticle.snapshot(_t.state["params"]),
                                    here),
                None if g is None else jax.device_put(
                    jparticle.snapshot(g), here))
        return self.nel.dispatch(pid, grab, target, lightweight=True)

    send = jparticle.Particle.send

    def send_moved(self, pid, msg, *args, **kw):
        there = self.nel.device_of(pid)
        args = jax.tree.map(lambda x: jax.device_put(x, there)
                            if isinstance(x, jax.Array) else x, args)
        return send(self, pid, msg, *args, **kw)

    jparticle.Particle.get = get
    jparticle.Particle.send = send_moved
    N, EPOCHS, LR, CACHE = (int(x) if "." not in x else float(x)
                            for x in sys.argv[3:7])
    jcfg, tcfg = _cfgs()
    jmod, _ = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    algo = SteinVGD(jmod, num_devices=4, cache_size=CACHE, seed=0,
                    backend="nel",
                    placement=Placement(mesh=make_bench_mesh(4)))
    algo.push_dist.nel.offload = True
    pids, losses = algo.bayes_infer(
        DataLoader(jcfg, batch_size=8, num_batches=2, seed=0), EPOCHS,
        num_particles=N, lr=LR, lengthscale=0.0)
    params = [np.asarray(ravel_pytree(p)[0]).tolist()
              for p in algo.p_parameters()]
    # rows on four devices cannot stack (the reference's save would skip
    # the key): fetch them, then place the stack on the mesh and save
    for pid in pids:
        algo.store.write("params", pid,
                         jax.device_get(algo.store.read("params", pid)))
    placed = algo.store.stacked("params")
    assert len(jax.tree.leaves(placed)[0].sharding.device_set) == 4
    ckpt.save_store(sys.argv[1], 1, algo.store)
    print(json.dumps({"losses": [float(x) for x in losses],
                      "params": params,
                      "stats": dict(algo.push_dist.nel.stats)}))
    algo.cleanup()
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run: (losses, params, NEL stats, its store dir)."""
    out_dir = tmp_path_factory.mktemp("jax_store")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out_dir), str(REPO / "tests"),
         str(N), str(EPOCHS), str(LR), str(CACHE)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["losses"], np.asarray(got["params"]), got["stats"], out_dir


def _mesh4():
    return Placement(mesh=make_bench_mesh(4, devices=["cpu"] * 4))


@pytest.fixture(scope="module")
def port():
    """The port's run on a NEL over 4 logical CPU devices with offload."""
    jcfg, tcfg = _cfgs()
    _, tmod = _modules(jcfg, tcfg, _numpy_inits(jcfg, N))
    algo = SteinVGD(tmod, devices=["cpu"] * 4, cache_size=CACHE,
                    offload=True, placement=_mesh4(), device="cpu")
    pids, losses = _bounded(
        algo.bayes_infer, DataLoader(tcfg, batch_size=8, num_batches=2,
                                     seed=0), EPOCHS, num_particles=N,
        lr=LR, lengthscale=0.0)
    yield algo, pids, losses
    algo.cleanup()


def test_offloaded_nel_over_4_devices_matches_the_reference(reference, port):
    jloss, jparams, jstats, _ = reference
    algo, pids, losses = port
    assert np.abs(np.array(losses) - np.array(jloss)).max() < 1e-4
    got = np.stack([_flat_torch(p) for p in algo.p_parameters()])
    assert np.abs(got - jparams).max() < 1e-4
    nel = algo.push_dist.nel
    assert nel.offload and len(nel.devices) == 4
    for k in ("dispatches", "swaps_in", "swaps_out", "xdev_transfers"):
        assert nel.stats[k] == jstats[k], (k, nel.stats, jstats)
    assert nel.stats["swaps_out"] > 0 and nel.stats["xdev_transfers"] > 0
    assert nel.swap_stats["bytes_out"] > 0 and nel.swap_stats["bytes_in"] > 0


def test_offload_keeps_no_stacked_params_on_the_device(port):
    algo, pids, _ = port
    store, nel = algo.store, algo.push_dist.nel
    assert not store.is_stacked("params") and store.keep_row_devices
    resident = {pid for active in nel._active for pid in active}
    assert 0 < len(resident) <= CACHE * len(nel.devices) < N
    for pid in pids:
        if pid not in resident:
            # the host buffer the NEL copied the row into, reused
            row = algo.push_dist.particles[pid].state["params"]
            pairs = list(zip(tree_leaves(row), tree_leaves(nel._host[pid])))
            assert pairs and all(a is b for a, b in pairs)
    # a fused consumer restacks them on the mesh (one placement)
    puts = store.snapshot_stats()["device_puts"]
    st = store.stacked("params")
    assert isinstance(st, Sharded) and len(st.shards) == 4
    assert store.snapshot_stats()["device_puts"] == puts + 1


def test_mesh_store_checkpoints_go_both_ways(reference, port, tmp_path):
    _, jparams, _, jdir = reference
    algo, pids, _ = port
    # the reference's mesh store onto the port's 4-position mesh
    _, store = restore_store(str(jdir), placement=_mesh4(), device="cpu")
    assert store.placement == _mesh4()
    st = store.stacked("params")
    assert isinstance(st, Sharded) and len(st.shards) == 4
    got = np.stack([_flat_torch(store.read("params", p)) for p in
                    store.pids])
    assert np.array_equal(got, jparams.astype(np.float32))
    # no CUDA device here: the saved plan falls back to mesh=None
    _, plain = restore_store(str(jdir), device="cpu")
    assert plain.placement.mesh is None
    # the port's mesh store, read by the reference
    path = save_store(str(tmp_path), 3, algo.store)
    with np.load(path) as data:
        manifest = json.loads(str(data["__store_manifest__"]))
    assert manifest["placement"]["mesh_shape"] == [4, 1]
    assert manifest["placement"]["mesh_axes"] == ["data", "model"]
    _, jstore = jckpt.restore_store(str(tmp_path), 3)
    want = np.stack([_flat_torch(p) for p in algo.p_parameters()])
    from jax.flatten_util import ravel_pytree
    back = np.stack([np.asarray(ravel_pytree(jstore.read("params", p))[0])
                     for p in jstore.pids])
    assert np.array_equal(back, want)
    with pytest.raises(ValueError, match="present"):
        SteinVGD(algo.module, num_devices=torch.cuda.device_count() + 5,
                 device="cuda")
