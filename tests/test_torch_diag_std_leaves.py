"""SWAG's diagonal scale over every leaf in one launch (#4 redesigned), on
the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it bit for bit against the per-leaf kernel there);
what surrounds it is checked here:

  * the plan (``swag_moments.leaves_plan`` at one row of each leaf's
    whole length) takes every (leaf, element) in exactly one work item
    for any lengths and SM count, at most ``MAX_LEAVES`` leaves a launch
    (its parameters under 4 KB), and the kernel's forward-only leaf walk
    finds each item's leaf; the output layout puts every leaf on a
    16-byte boundary without overlap;
  * ``ops.diag_std_leaves`` on the CPU equals the per-leaf plain
    ``ref.diag_std`` bit for bit on a ViT-like and a UNet-like tree, with
    empty leaves and with more than 64 leaves, and matches the
    reference's ``diag_std_flat`` (Pallas, interpret mode, over the tree
    raveled as the reference ravels it) within 1e-5;
  * ``MultiSWAG.sample_predict``, which computes each particle's scale
    once for its S draws, equals the per-draw path (``swag_sample`` with
    the scale computed at every draw) bit for bit;
  * ``ref.diag_std_leaves`` (the plain version the CPU dispatches to) is
    called once a ``posterior_predictive`` handoff, once a position of a
    store split over a mesh, and once a live particle in
    ``sample_predict``;
  * the CUDA wrapper refuses CPU tensors without counting a launch and
    the dispatch raises on other devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import swag_moments as jswag_moments
from repro_torch import configs as tconfigs
from repro_torch.bdl import MultiSWAG, swag_sample
from repro_torch.bdl import swag as tswag
from repro_torch.core import ParticleModule
from repro_torch.core.store import Placement
from repro_torch.core.tree import to_device, tree_leaves, tree_map
from repro_torch.data import DataLoader
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swag_moments
from repro_torch.kernels.swag_moments import (CHUNK, MAX_LEAVES,
                                              diag_layout, leaves_plan)
from repro_torch.launch import make_bench_mesh
from repro_torch.models import api as tapi

TINY = dict(n_units=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64)
N, CAP = 6, 8

# a ViT-like tree (the 2-D and 1-D leaves of an encoder unit), a
# UNet-like tree (conv kernels (k, cin, cout), odd widths, 1-element
# biases), each stacked over P rows, with empty leaves among them
VIT_TREE = [(5, 16), (16,), (16, 48), (0,), (48,), (16, 16), (16,),
            (64, 16), (10,)]
UNET_TREE = [(3, 1, 8), (8,), (3, 8, 8), (8,), (3, 8, 16), (0, 4), (16,),
             (3, 24, 8), (8,), (1, 8, 1), (1,)]
MANY_TREE = [(37,), (64,), (1,), (0,)] * 40        # 120 non-empty leaves


# -- the plan and the layout ---------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.lists(st.one_of(st.integers(1, 70), st.integers(1, 20_000)),
                min_size=1, max_size=150),
       st.sampled_from([1, 3, 132]))
def test_diag_plan_covers_every_element_once(numels, sms):
    plan = leaves_plan(1, tuple(numels), sms)
    assert len(plan.groups) == -(-len(numels) // MAX_LEAVES)
    assert [j for g in plan.groups for j in g] == list(range(len(numels)))
    cover = [np.zeros(L, np.int64) for L in numels]
    for k, (group, starts, items, grid) in enumerate(zip(
            plan.groups, plan.starts, plan.items, plan.grids)):
        assert 1 <= len(group) <= MAX_LEAVES
        # csrc swag_diag_std_leaves: ceil(numel / kChunk) items a leaf
        assert list(starts) == list(np.cumsum(
            [0] + [-(-numels[j] // CHUNK) for j in group])[:-1])
        assert items == sum(-(-numels[j] // CHUNK) for j in group)
        assert 1 <= grid <= min(items, sms * 2)
        for b in range(grid):
            at = 0                  # the kernel's forward-only leaf walk
            for i in range(b, items, grid):
                while at + 1 < len(group) and i >= starts[at + 1]:
                    at += 1
                leaf, p, span = plan.item(k, i)
                assert leaf == group[at] and p == 0
                assert span.start == (i - starts[at]) * CHUNK
                cover[leaf][span.start:span.stop] += 1
    assert all((c == 1).all() for c in cover)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=1, max_size=100))
def test_diag_layout_aligns_every_leaf_without_overlap(numels):
    offsets, total = diag_layout(numels)
    assert len(offsets) == len(numels)
    assert all(o % 4 == 0 for o in offsets)
    ends = [o + L for o, L in zip(offsets, numels)]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert total >= max(ends) and total - max(ends) < 4
    assert total == sum(-(-L // 4) * 4 for L in numels)


# -- the plain side ------------------------------------------------------------

def _tree(seed, P, shapes):
    """(means, sqs) numpy leaves of (P,) + shape; a third of each leaf's
    entries has sq below mean^2 (the scale clamped at 1e-30)."""
    rng = np.random.default_rng(seed)
    means, sqs = [], []
    for s in shapes:
        m = rng.standard_normal((P,) + s).astype(np.float32)
        q = (m * m + np.abs(rng.standard_normal(m.shape))).astype(np.float32)
        low = rng.random(m.shape) < 1 / 3
        q[low] = 0.5 * m[low] ** 2 - 1e-3
        means.append(m)
        sqs.append(q)
    return means, sqs


def _torch(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("shapes", [VIT_TREE, UNET_TREE, MANY_TREE],
                         ids=["vit", "unet", "many"])
def test_diag_std_leaves_plain_equals_per_leaf(shapes, P):
    means, sqs = _tree(len(shapes) + P, P, shapes)
    got = ops.diag_std_leaves(_torch(means), _torch(sqs))
    assert len(got) == len(shapes)
    for g, m, s in zip(got, _torch(means), _torch(sqs)):
        assert g.shape == m.shape and g.dtype == torch.float32
        assert torch.equal(g, ref.diag_std(m, s))
    # the plain version the dispatch took is the list form of the same
    for a, b in zip(got, ref.diag_std_leaves(_torch(means), _torch(sqs))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shapes", [VIT_TREE, UNET_TREE],
                         ids=["vit", "unet"])
def test_diag_std_leaves_matches_jax_diag_std_flat(shapes):
    """Against the reference's kernel over the tree raveled (one
    ``diag_std_flat`` a particle, as the reference's sampling makes it),
    1e-5."""
    P = 3
    means, sqs = _tree(11, P, shapes)
    got = ops.diag_std_leaves(_torch(means), _torch(sqs))
    for p in range(P):
        flat_m = np.concatenate([m[p].ravel() for m in means])
        flat_s = np.concatenate([s[p].ravel() for s in sqs])
        want = np.asarray(jswag_moments.diag_std_flat(jnp.asarray(flat_m),
                                                      jnp.asarray(flat_s)))
        mine = np.concatenate([g[p].numpy().ravel() for g in got])
        assert mine.shape == want.shape
        assert np.abs(mine - want).max() < 1e-5


def test_diag_std_leaves_dispatch_has_no_other_branch():
    """The CUDA wrapper refuses CPU tensors and counts no launch; the
    dispatch takes the plain version on the CPU and raises on any other
    device."""
    t = torch.ones(3, 8)
    before = swag_moments.diag_std_leaves.launches
    with pytest.raises(ValueError, match="CUDA"):
        swag_moments.diag_std_leaves([t, t], [t, t])
    with pytest.raises(ValueError):
        swag_moments.diag_std_leaves([], [])
    assert swag_moments.diag_std_leaves.launches == before
    assert swag_moments.diag_std_leaves in ops.COUNTED
    assert isinstance(ops.diag_std_leaves([t], [t]), list)
    with pytest.raises(ValueError, match="device"):
        ops.diag_std_leaves([t.to("meta")], [t.to("meta")])


# -- the sampling path: one scale a particle -------------------------------------

def _module():
    cfg = tconfigs.get("vit-mnist").smoke().replace(**TINY)
    return ParticleModule(lambda g: tapi.init_params(g, cfg),
                          lambda p, b: tapi.loss_fn(p, b, cfg),
                          lambda p, b: tapi.forward(p, b, cfg)[0], cfg=cfg)


def _trained(placement=None):
    """A port MultiSWAG of N particles in a store of capacity CAP, two
    collections (so a draw is not the mean)."""
    from repro_torch.optim import sgd
    module = _module()
    algo = MultiSWAG(module, seed=0, backend="compiled", capacity=CAP,
                     device="cpu", placement=placement)
    algo.bayes_infer(DataLoader(module.cfg, batch_size=8, num_batches=2,
                                seed=0), 2, optimizer=sgd(0.05),
                     num_particles=N, pretrain_epochs=0, max_rank=3)
    return algo


@pytest.fixture(scope="module")
def trained():
    return _trained()


def _batch(algo, seed=5):
    return to_device(next(iter(DataLoader(algo.module.cfg, batch_size=4,
                                          num_batches=1, seed=seed))), "cpu")


def _noise(algo, S, seed=3):
    gen = torch.Generator().manual_seed(seed)
    pd, noise = algo.push_dist, []
    for pid in pd.particle_ids():
        swag = pd.particles[pid].state["swag"]
        for _ in range(S):
            noise.append((tree_map(lambda m: torch.randn(
                m.shape, generator=gen), swag["mean"]),
                torch.randn(3, generator=gen)))
    return noise


def _counted(monkeypatch):
    calls = []
    plain = ref.diag_std_leaves

    def counted(means, sqs):
        calls.append(len(means))
        return plain(means, sqs)

    monkeypatch.setattr(ref, "diag_std_leaves", counted)
    return calls


def test_sample_predict_reuses_the_scale_bit_for_bit(trained):
    """The scale computed once a particle and reused over its draws gives
    the per-draw path's logits bit for bit, on the same noise."""
    algo, S = trained, 3
    batch, noise = _batch(algo), _noise(algo, 3)
    got = algo.sample_predict(batch, samples_per_particle=S, scale=0.5,
                              noise=noise)
    pd, draws, total = algo.push_dist, iter(noise), None
    with torch.no_grad():
        for pid in pd.particle_ids():
            swag = pd.particles[pid].state["swag"]
            for _ in range(S):
                z1, z2 = next(draws)
                out = algo.module._forward(swag_sample(swag, z1, z2, 0.5),
                                           batch)
                total = out if total is None else tree_map(torch.add,
                                                           total, out)
    want = tree_map(lambda t: t / (len(pd.particle_ids()) * S), total)
    assert torch.equal(got, want)
    # the draws are live: not the logits of the mean params
    assert (got - algo.posterior_pred(batch)).abs().max() > 1e-3


def test_swag_sample_with_given_scales_equals_its_own(trained):
    swag = trained.push_dist.particles[
        trained.push_dist.particle_ids()[2]].state["swag"]
    z1, z2 = _noise(trained, 1)[0]
    stds = tswag.diag_scales(tree_map(lambda x: x[None], swag))
    a = swag_sample(swag, z1, z2, 0.7, stds)
    b = swag_sample(swag, z1, z2, 0.7)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_one_scale_call_a_handoff_and_a_particle(trained, monkeypatch):
    algo = trained
    calls = _counted(monkeypatch)
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    with algo.posterior_predictive(
            samples_per_particle=2, warmup=False,
            generator=torch.Generator().manual_seed(0)) as svc:
        heads = svc.predict_batch(_batch(algo))
    assert calls == [n_leaves]              # one call over every leaf
    assert torch.isfinite(heads["mean"]).all()
    calls.clear()
    algo.sample_predict(_batch(algo), samples_per_particle=3,
                        noise=_noise(algo, 3))
    assert calls == [n_leaves] * N          # one a live particle, not 3N
    calls.clear()
    algo.sample_predict(_batch(algo), samples_per_particle=2,
                        generator=torch.Generator().manual_seed(1))
    assert calls == [n_leaves] * N


def test_one_scale_call_a_mesh_position(monkeypatch):
    """On a store split over four positions (two slots each, six live
    particles: three positions hold live rows) the handoff samples on
    each position with one call there."""
    mesh = Placement(mesh=make_bench_mesh(4, devices=["cpu"] * 4))
    algo = _trained(mesh)
    calls = _counted(monkeypatch)
    with algo.posterior_predictive(
            samples_per_particle=2, warmup=False,
            generator=torch.Generator().manual_seed(0)) as svc:
        heads = svc.predict_batch(_batch(algo))
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    assert calls == [n_leaves] * 3
    assert torch.isfinite(heads["mean"]).all()
    algo.cleanup()
