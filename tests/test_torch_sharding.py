"""The model axis's sharding rules and activation policy against the
reference's (``repro.sharding``), on the CPU.

  * ``param_spec`` / ``tree_param_specs`` give the reference's
    ``PartitionSpec``s as tuples, leaf for leaf by key path, on the param
    trees of a tiny qwen, a llama3-8b stand-in, a tiny ViT, an int8 serve
    pack and a ``kv_pages`` tree, at model sizes 1, 2 and 4: with a
    vocab the axis does not divide (the divisibility drop) and with the
    model axis named otherwise (the remap);
  * ``tp_activation_policy`` equals the reference's, and the per-position
    shapes the tensor-parallel forward records at every ``maybe_shard``
    name equal the policy's specs after the drop, kv heads the axis does
    not divide included;
  * a split then a join gives the same bits back, leaf by leaf and
    through ``Placement.split`` / ``Sharded.gather``.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import precision as jprecision
from repro.models import api as japi
from repro.sharding import policy as jpolicy
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.core import precision as tprecision
from repro_torch.core.functional import stack_pytrees
from repro_torch.core.store import Placement
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import make_bench_mesh
from repro_torch.models import api as tapi
from repro_torch.sharding import policy, rules

QWEN = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=64)
LLAMA = dict(n_units=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=8,
             d_ff=128, vocab_size=256, max_seq_len=64)
VIT = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
           d_ff=64)


def _cfgs(name, kw):
    return jconfigs.get(name).replace(**kw), tconfigs.get(name).replace(**kw)


def _trees(kind):
    """(reference shape tree, port meta tree) of one kind."""
    if kind == "kv_pages":
        jcfg, tcfg = _cfgs("qwen1.5-0.5b", QWEN)
        jt = jax.eval_shape(lambda: japi.paged_cache_init(
            jcfg, num_pages=8, page_size=4))
        tt = tapi.paged_cache_init(tcfg, num_pages=7, page_size=4,
                                   device=torch.device("meta"))
        return jt, tt
    name, kw = {"qwen": ("qwen1.5-0.5b", QWEN),
                "qwen-odd-vocab": ("qwen1.5-0.5b", dict(QWEN,
                                                        vocab_size=130)),
                "llama": ("llama3-8b", LLAMA), "vit": ("vit-mnist", VIT),
                "int8": ("qwen1.5-0.5b", QWEN)}[kind]
    jcfg, tcfg = _cfgs(name, kw)
    jt = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    gen = torch.Generator().manual_seed(0)
    tt = tapi.init_params(gen, tcfg)
    if kind == "int8":
        # a stacked serve pack (leading particle axis of 2)
        jt = jax.eval_shape(lambda t: jprecision.quantize_int8(
            jax.tree.map(lambda x: jax.numpy.stack([x, x]), t)), jt)
        tt = tprecision.quantize_int8(stack_pytrees([tt, tt]))
    return jt, tt


def _jax_specs(tree, m, model_axis, particle_axis):
    mesh = types.SimpleNamespace(shape={"data": 1, model_axis: m})
    specs = jrules.tree_param_specs(tree, "tp", particle_axis, mesh=mesh,
                                    model_axis=model_axis)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jrules.normalize_path(p): tuple(s) for p, s in flat}


def _port_specs(tree, m, model_axis, particle_axis):
    specs = rules.tree_param_specs(tree, "tp", particle_axis,
                                   mesh_shape={"data": 1, model_axis: m},
                                   model_axis=model_axis)
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                walk(x, s[i], path + (i,))
        elif t is not None:
            out[rules.normalize_path(path)] = s

    walk(tree, specs, ())
    return out


def _pad(spec, n):
    """A reference spec padded with None to ``n`` dims (PartitionSpec
    drops nothing, but a tuple comparison needs the same length)."""
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind", ["qwen", "qwen-odd-vocab", "llama", "vit",
                                  "int8", "kv_pages"])
@pytest.mark.parametrize("model_axis", ["model", "tensor"])
def test_param_specs_equal_the_reference(kind, m, model_axis):
    jt, tt = _trees(kind)
    for pa in (None, "data"):
        want = _jax_specs(jt, m, model_axis, pa)
        got = _port_specs(tt, m, model_axis, pa)
        shapes = dict(rules.named_leaves(tt))
        assert set(got) == set(want), kind
        for path, spec in got.items():
            assert spec == _pad(want[path], len(spec)), (kind, path)
            assert len(spec) == len(shapes[path].shape)
    if kind == "qwen-odd-vocab" and m == 4:
        # 130 rows: a 4-way axis does not divide the vocab, the embed is
        # whole
        assert _port_specs(tt, m, model_axis, None)["embed"] == (None, None)
        assert rules.model_dims(tt, m, model_axis=model_axis)["embed"] is None
    if kind == "kv_pages" and m == 4:
        # 2 kv heads on a 4-way axis: replicated pages
        assert all(d is None for d in rules.model_dims(tt, m).values())


def test_spec_tail_and_remap_equal_the_reference():
    for path in ("units/0/attn/wq/w", "units/0/attn/wq/b", "mlp/w2/b",
                 "units/0/mlp/wi/w/q", "units/0/mlp/wi/w/s", "embed",
                 "lm_head/w", "head/w", "patch/w", "units/0/k", "cls",
                 "mean/units/0/attn/wo/w", "dev/units/0/mlp/w1/w"):
        for mode in ("tp", "fsdp_tp"):
            assert rules.spec_tail(path, mode) == jrules.spec_tail(path, mode)
    tail = ("model", None, "data")
    for axis in ("model", "tensor", None):
        assert rules._remap_tail(tail, axis) == jrules._remap_tail(tail, axis)


def test_activation_policy_equals_the_reference():
    shape = {"data": 2, "model": 2}
    want = jpolicy.tp_activation_policy(shape)
    got = policy.tp_activation_policy(shape)
    assert set(got) == set(want)
    for name, spec in want.items():
        if name == "__mesh__":
            assert got[name] == spec
        else:
            assert got[name] == tuple(spec), name
    pl = Placement(mesh=make_bench_mesh(4, model=2, devices=["cpu"] * 4))
    assert pl.activation_policy() == got
    assert Placement(mesh=make_bench_mesh(
        4, devices=["cpu"] * 4)).activation_policy() is None
    # no policy: the hook hands the tensor back and records nothing
    x = torch.zeros(2, 3, 4)
    assert policy.maybe_shard(x, "residual") is x
    assert policy.recorded() == []


@pytest.mark.parametrize("kv", [2, 1])
def test_recorded_shapes_follow_the_policy(kv):
    """The tensor-parallel loss of a tiny qwen on a 2 x 2 plan, under the
    plan's policy: every per-position shape recorded at a ``maybe_shard``
    site equals the policy's spec of the whole tensor, after the drop
    (one kv head: ``attn_kv`` stays whole)."""
    _, tcfg = _cfgs("qwen1.5-0.5b", dict(QWEN, n_kv_heads=kv))
    gen = torch.Generator().manual_seed(0)
    stacked = stack_pytrees([tapi.init_params(gen, tcfg) for _ in range(2)])
    pl = Placement(mesh=make_bench_mesh(4, model=2, devices=["cpu"] * 4))
    group = pl.split(stacked).shards[0]
    B, S = 2, 5
    tokens = torch.arange(B * S).reshape(B, S) % tcfg.vocab_size
    pol = pl.activation_policy()
    full = {"attn_heads": (B, S, tcfg.n_heads, tcfg.hd),
            "attn_kv": (B, S, kv, tcfg.hd),
            "mlp_hidden": (B, S, tcfg.d_ff),
            "logits": (B, S, tcfg.vocab_size),
            "residual": (B, S, tcfg.d_model)}
    with policy.activation_policy(pol), torch.no_grad():
        tapi.loss_fn(group, {"tokens": tokens, "labels": tokens}, tcfg)
        seen = policy.recorded()
    assert {n for n, _ in seen} == set(full)
    for name, shape in seen:
        assert shape == policy.expected_shape(pol, name, full[name]), name
    # and the reference's own drop agrees on the same whole shapes
    for name, whole in full.items():
        spec = jpolicy.tp_activation_policy(pol["__mesh__"])[name]
        want = tuple(d // 2 if ax == "model" and d % 2 == 0 else d
                     for d, ax in zip(whole, _pad(spec, len(whole))))
        assert policy.expected_shape(pol, name, whole) == want


@pytest.mark.parametrize("m", [2, 4])
def test_split_then_join_gives_the_same_bits(m):
    _, tcfg = _cfgs("llama3-8b", LLAMA)
    gen = torch.Generator().manual_seed(1)
    stacked = stack_pytrees([tapi.init_params(gen, tcfg) for _ in range(4)])
    dims = rules.model_dims(stacked, m, lead=1)
    assert any(d is not None for d in dims.values())
    for path, x in rules.named_leaves(stacked):
        parts = [rules.split_leaf(x, dims[path], m, j) for j in range(m)]
        if dims[path] is not None:
            assert parts[0].shape[dims[path]] * m == x.shape[dims[path]]
        assert torch.equal(rules.join_leaf(parts, dims[path]), x)
    pl = Placement(mesh=make_bench_mesh(4, model=m, devices=["cpu"] * 4))
    sharded = pl.split(stacked)
    assert len(sharded.shards) == 4 // m
    back = sharded.gather()
    for a, b in zip(tree_leaves(stacked), tree_leaves(back)):
        assert torch.equal(a, b)
