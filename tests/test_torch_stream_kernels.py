"""The launch plans and the plain sides of the streamed SVGD force (#2) and
the one-launch SWAG collection (#3), on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them bit for bit against the first design's
kernels there);
what surrounds them is checked here:

  * ``svgd_rbf.force_plan``: every (row, column) of phi is computed by
    exactly one (block, thread) for any n <= 256, any D (odd, a multiple
    of 4, tiny) and SM count, on the vector path (a grid of whole row
    tiles in one wave) and the scalar path (one column tile a block);
  * ``swag_moments.leaves_plan``: every (leaf, row, element) is one work
    item's, each launch holds at most ``MAX_LEAVES`` leaves (its
    parameters under 4 KB), and the kernel's forward-only leaf walk finds
    each item's leaf;
  * ``ops.swag_moments_leaves`` on the CPU equals the per-leaf plain
    version bit for bit on a ViT-like and a UNet-like tree with dead
    rows holding NaN, and matches the reference's ``update_moments``
    (Pallas, interpret mode, as ``tests/test_bdl.py`` runs it) within
    1e-5 on the live rows; bf16 params through ``leaves_via_fp32``
    equal the fp32 collection on their widened values, the ring cast;
  * ``svgd_force(out=)`` writes the very tensor it returns, bit for bit
    the force without ``out``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import swag_moments as jswag_moments
from repro_torch.bdl import svgd as tsvgd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import svgd_rbf
from repro_torch.kernels.svgd_rbf import force_plan
from repro_torch.kernels.swag_moments import (CHUNK, MAX_LEAVES, PARAM_BYTES,
                                              leaves_plan)

_D = st.one_of(st.integers(1, 64),
               st.integers(1, 5000).map(lambda x: 4 * x),
               st.integers(0, 10_000).map(lambda x: 2 * x + 1))


# -- #2: the force's plan -----------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.integers(1, 256), _D, st.sampled_from([1, 7, 132]), st.booleans())
def test_force_plan_covers_every_row_and_column_once(n, D, sms, aligned):
    plan = force_plan(n, D, sms, aligned)
    assert plan.path == ("vector" if aligned and D % 4 == 0 else "scalar")
    assert plan.rows == min(n, 8) and plan.row_tiles == -(-n // plan.rows)
    vec = plan.path == "vector"
    assert plan.cols == ((8 if n <= 2 else 4) if vec else (4 if n <= 4 else 2))
    assert plan.tile_cols == 256 * plan.cols
    # a grid of whole row tiles, at least one block each: one wave on the
    # vector path, one column tile a block on the scalar path
    assert plan.grid % plan.row_tiles == 0 and plan.grid >= plan.row_tiles
    if vec:
        assert plan.grid <= max(sms * plan.blocks_per_sm, plan.row_tiles)
    else:
        assert plan.grid == plan.ntiles * plan.row_tiles
    # each row tile's blocks take every column tile once
    rows, tiles = {}, {}
    for b in range(plan.grid):
        r = tuple(plan.row_tile(b))
        rows.setdefault(b % plan.row_tiles, r)
        assert rows[b % plan.row_tiles] == r
        tiles.setdefault(r, []).extend(plan.tiles(b))
    assert sorted(x for r in tiles for x in r) == list(range(n))
    for got in tiles.values():
        assert sorted(got) == list(range(plan.ntiles))
    # the threads of a tile take its columns once each
    cover = np.zeros(D, np.int64)
    for tile in range(plan.ntiles):
        for thread in range(256):
            cols = plan.columns(tile, thread)
            if plan.path == "vector":    # whole float4 groups, aligned
                assert len(cols) % 4 == 0
                assert all(c % 4 == 0 for c in cols[::4])
            np.add.at(cover, cols, 1)
    assert (cover == 1).all()


def test_force_plan_at_the_driven_shapes():
    # deepseek-moe (phase 17 (b)), qwen1.5-0.5b (phase 13), the ViT
    # (phases 3-4), the UNet (phase 12, D odd: scalar loads), n = 256
    zoo = force_plan(2, 1_093_281_792, 132)
    assert (zoo.path, zoo.cols, zoo.grid, zoo.blocks_per_sm) == \
        ("vector", 8, 528, 4)
    lm = force_plan(4, 463_987_712, 132)
    assert (lm.path, lm.cols, lm.grid) == ("vector", 4, 528)
    vit = force_plan(8, 19_775_360, 132)
    assert (vit.path, vit.rows, vit.grid) == ("vector", 8, 264)
    unet = force_plan(8, 1_240_065, 132)
    assert (unet.path, unet.cols, unet.grid) == ("scalar", 2, 2423)
    assert force_plan(8, 19_775_360, 132, aligned=False).path == "scalar"
    wide = force_plan(256, 1_000_000, 132)
    assert (wide.rows, wide.row_tiles, wide.grid) == (8, 32, 256)
    with pytest.raises(ValueError):
        force_plan(0, 10, 132)


# -- #3: the leaves' plan -------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.integers(1, 8),
       st.lists(st.one_of(st.integers(1, 70), st.integers(1, 6000)),
                min_size=1, max_size=150),
       st.sampled_from([1, 3, 132]))
def test_leaves_plan_covers_every_element_once(P, lengths, sms):
    plan = leaves_plan(P, tuple(lengths), sms)
    assert PARAM_BYTES <= 4096
    assert len(plan.groups) == -(-len(lengths) // MAX_LEAVES)
    assert [j for g in plan.groups for j in g] == list(range(len(lengths)))
    cover = [np.zeros((P, L), np.int64) for L in lengths]
    for k, (group, starts, items, grid) in enumerate(zip(
            plan.groups, plan.starts, plan.items, plan.grids)):
        assert 1 <= len(group) <= MAX_LEAVES
        assert items == sum(P * -(-lengths[j] // CHUNK) for j in group)
        assert 1 <= grid <= min(items, sms * 2)
        for b in range(grid):
            at = 0                  # the kernel's forward-only leaf walk
            for i in range(b, items, grid):
                while at + 1 < len(group) and i >= starts[at + 1]:
                    at += 1
                leaf, p, span = plan.item(k, i)
                assert leaf == group[at]
                cover[leaf][p, span.start:span.stop] += 1
    assert all((c == 1).all() for c in cover)


def test_leaves_plan_splits_past_max_leaves():
    plan = leaves_plan(8, (5,) * (2 * MAX_LEAVES + 1), 132)
    assert [len(g) for g in plan.groups] == [MAX_LEAVES, MAX_LEAVES, 1]
    assert plan.items == (8 * MAX_LEAVES, 8 * MAX_LEAVES, 8)


# -- #3: the plain side of the one-launch collection ----------------------------

# a ViT-like tree (the 2-D and 1-D leaves of an encoder unit) and a
# UNet-like tree (conv kernels (k, cin, cout), odd widths, 1-element biases)
VIT_TREE = [(5, 16), (16,), (16, 48), (48,), (16, 16), (16,), (64, 16),
            (10,)]
UNET_TREE = [(3, 1, 8), (8,), (3, 8, 8), (8,), (3, 8, 16), (16,),
             (3, 24, 8), (8,), (1, 8, 1), (1,)]


def _tree_case(seed, P, shapes, R=4, dead=(1,)):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal((P,) + s).astype(np.float32)
    means = [mk(s) for s in shapes]
    sqs = [m * m + np.abs(mk(m.shape[1:])) for m in means]
    thetas = [mk(s) for s in shapes]
    devs = [rng.standard_normal((P, R) + s).astype(np.float32)
            for s in shapes]
    n = rng.integers(0, 6, P).astype(np.float32)
    slot = (rng.integers(0, 9, P) % R).astype(np.int32)
    mask = np.ones(P, np.float32)
    mask[list(dead)] = 0.0
    for t in thetas:
        t[mask == 0] = np.nan
    return means, sqs, thetas, devs, n, slot, mask


def _tensors(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("shapes", [VIT_TREE, UNET_TREE],
                         ids=["vit", "unet"])
def test_moments_leaves_plain_equals_per_leaf_and_jax(shapes):
    P = 4
    means, sqs, thetas, devs, n, slot, mask = _tree_case(len(shapes), P,
                                                         shapes)
    tn, tslot, tmask = (torch.from_numpy(x) for x in (n, slot, mask))
    got = [_tensors(x) for x in (means, sqs, devs)]
    out = ops.swag_moments_leaves(got[0], got[1], _tensors(thetas), tn,
                                  tmask, got[2], tslot)
    assert all(a is b for a, b in zip(out[0], got[0]))
    assert all(a is b for a, b in zip(out[1], got[1]))
    want = [_tensors(x) for x in (means, sqs, devs)]
    for m, s, t, d in zip(*want[:2], _tensors(thetas), want[2]):
        ref.swag_moments(m, s, t, tn, tmask, d, tslot, out_mean=m, out_sq=s)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)
    # dead rows untouched; the live rows against the reference's kernel
    for i in range(len(shapes)):
        assert np.array_equal(got[0][i][1].numpy(), means[i][1])
        assert np.array_equal(got[2][i][1].numpy(), devs[i][1])
    for p in (0, 2, 3):
        jm, js = jswag_moments.update_moments(
            [jnp.asarray(m[p]) for m in means],
            [jnp.asarray(s[p]) for s in sqs],
            [jnp.asarray(t[p]) for t in thetas], float(n[p]))
        for i in range(len(shapes)):
            assert np.abs(got[0][i][p].numpy() - np.asarray(jm[i])).max() \
                < 1e-5
            assert np.abs(got[1][i][p].numpy() - np.asarray(js[i])).max() \
                < 1e-5
            dev = thetas[i][p] - np.asarray(jm[i])
            assert np.abs(got[2][i][p, slot[p]].numpy() - dev).max() < 1e-5


def test_moments_leaves_bf16_params_equal_the_fp32_path():
    """bf16 masters: one call over the tree through ``leaves_via_fp32``
    equals the fp32 collection on the widened params, with each live
    row's deviation cast to the bf16 ring, bit for bit; dead rows keep
    their ring slot."""
    means, sqs, thetas, devs, n, slot, mask = _tree_case(7, 3, UNET_TREE)
    tn, tslot, tmask = (torch.from_numpy(x) for x in (n, slot, mask))
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in thetas]
    got = (_tensors(means), _tensors(sqs),
           [torch.from_numpy(d).to(torch.bfloat16) for d in devs])
    ops.swag_moments_leaves(got[0], got[1], bf, tn, tmask, got[2], tslot)
    want = _tensors(means), _tensors(sqs)
    ops.swag_moments_leaves(*want, [t.float() for t in bf], tn, tmask)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    for i, d in enumerate(devs):
        ring = torch.from_numpy(d).to(torch.bfloat16)
        for p in (0, 2):
            ring[p, slot[p]] = (bf[i][p].float() - want[0][i][p]).to(
                torch.bfloat16)
        assert torch.equal(got[2][i], ring)


# -- #2: the force into ``out`` -------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_force_out_is_written_in_place(masked):
    rng = np.random.default_rng(3)
    n, D = 5, 77
    theta = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0]) if masked else None
    glue = tsvgd.rbf_glue(ops.pairwise_sqdist(theta, mask), 0.0, mask)
    want = ops.svgd_force(theta, g, *glue, mask)
    out = torch.full((n, D), float("nan"))
    got = ops.svgd_force(theta, g, *glue, mask, out=out)
    assert got is out and torch.equal(out, want)
    with pytest.raises(ValueError, match="CUDA"):
        svgd_rbf.svgd_force(theta, g, *glue, mask, out=out)
