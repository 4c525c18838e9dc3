"""The port's run plans, specs and abstract inputs (``repro_torch.launch``)
against the reference's (``repro.launch``), on the CPU.

  * ``plan_for`` equals the reference's for every arch and input shape,
    with ``tests/test_launch.py``'s coherence checks;
  * ``batch_specs`` / ``cache_specs`` / ``residual_policy`` equal the
    reference's entry by entry on a 1 x 1 mesh (the specs as tuples);
  * ``build``'s abstract trees equal the reference's ``jax.eval_shape``
    trees (paths, shapes, dtypes) for one arch of each LM family at a
    train and a decode shape, cut to smoke width as ``tests/
    test_launch.py`` cuts them; the port's cache ``pos`` is shared by the
    particles (no particle axis), its one known difference;
  * the production mesh's axes.
Every comparison is exact.
"""
import dataclasses

import jax
import pytest

from repro import configs as jconfigs
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.launch import mesh as jmesh
from repro.launch import steps as JS
from repro.launch.plans import plan_for as jplan_for
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import make_mesh, make_production_mesh, steps as TS
from repro_torch.launch.plans import plan_for
from repro_torch.sharding import rules as trules

FAMILIES = ("qwen1.5-0.5b", "deepseek-moe-16b", "rwkv6-7b", "zamba2-1.2b",
            "whisper-medium", "paligemma-3b")


@pytest.mark.parametrize("arch", sorted(tconfigs.ALL))
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_plan_equals_reference(arch, shape):
    plan = plan_for(tconfigs.get(arch), INPUT_SHAPES[shape])
    want = jplan_for(jconfigs.get(arch), JSHAPES[shape])
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
    shp = INPUT_SHAPES[shape]
    assert plan.particles >= 1
    if shp.kind == "train":
        assert shp.global_batch % plan.microbatches == 0
    if plan.particle_axis is not None:
        assert plan.particles % 16 == 0


def test_production_mesh_axes():
    mesh = make_production_mesh()
    assert mesh.axis_names == ("data", "model") and mesh.size == 256
    assert mesh.shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in mesh.flat_devices()} <= {"cuda", "meta"}


def _cut(shape):
    return dataclasses.replace(INPUT_SHAPES[shape], seq_len=32,
                               global_batch=4)


def _jtree(tree):
    return {jrules.normalize_path(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ttree(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in trules.named_leaves(tree)}


def _builds(arch, shape):
    jm = jmesh.make_mesh((1, 1), ("data", "model"))
    tm = make_mesh((1, 1), ("data", "model"), TS.trace_devices(1))
    jplan = dataclasses.replace(jplan_for(jconfigs.get(arch),
                                          JSHAPES[shape]), particles=2)
    tplan = dataclasses.replace(plan_for(tconfigs.get(arch),
                                         INPUT_SHAPES[shape]), particles=2)
    with jax.set_mesh(jm):
        _, jargs, _ = JS.build(jconfigs.get(arch).smoke(), _cut(shape),
                               jplan, jm)
    _, targs, placement = TS.build(tconfigs.get(arch).smoke(), _cut(shape),
                                   tplan, tm)
    return (jm, jplan, jargs), (tm, tplan, targs), placement


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_abstract_trees_equal_reference(arch, shape):
    (_, _, jargs), (_, _, targs), placement = _builds(arch, shape)
    assert placement["kv_layout"] == "heads"
    assert len(jargs) == len(targs)
    for k, (ja, ta) in enumerate(zip(jargs, targs)):
        want, got = _jtree(ja), _ttree(ta)
        assert set(want) == set(got), (k, set(want) ^ set(got))
        for path, (shape_, dtype) in want.items():
            if path.rsplit("/", 1)[-1] == "pos" and shape == "decode_32k":
                shape_ = shape_[1:]      # shared by the particles
            assert got[path] == (shape_, dtype), (k, path)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b",
                                  "whisper-medium", "rwkv6-7b"])
def test_specs_equal_reference(arch):
    (jm, jplan, jargs), (tm, tplan, targs), _ = _builds(arch, "decode_32k")
    want = JS.cache_specs(jconfigs.get(arch).smoke(), jplan, jm, jargs[2], 4)
    got = TS.cache_specs(tconfigs.get(arch).smoke(), tplan, tm, targs[2], 4)
    want = {jrules.normalize_path(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    got = dict(_spec_leaves(got))
    assert set(want) == set(got)
    for path, spec in want.items():
        if path.rsplit("/", 1)[-1] == "pos":
            spec = spec[1:]
        assert got[path] == spec, path
    for shape in ("train_4k", "prefill_32k"):
        (jm, jplan, jargs), (tm, tplan, targs), _ = _builds(arch, shape)
        want = JS.batch_specs(jconfigs.get(arch).smoke(), jplan, jm, jargs[-1])
        got = TS.batch_specs(tconfigs.get(arch).smoke(), tplan, tm,
                             targs[-1])
        assert {k: tuple(v) for k, v in want.items()} == got
        want = JS.residual_policy(jconfigs.get(arch), jplan, jm)
        got = TS.residual_policy(tconfigs.get(arch), tplan, tm)
        assert set(want) == set(got)
        for name, spec in want.items():
            assert (spec if name == "__mesh__" else tuple(spec)) == got[name]


def _spec_leaves(tree, path=()):
    """(path, spec) of a tree whose leaves are spec tuples (non-empty
    tuples of axis names or None)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif tree and all(isinstance(a, (str, type(None))) for a in tree):
        yield trules.normalize_path(path), tuple(tree)
    else:
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
