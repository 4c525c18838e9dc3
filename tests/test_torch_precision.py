"""The port's precision ladder against the JAX package, on the CPU.

Ports the semantics of ``tests/test_precision.py`` and the bf16 serving
tests of ``tests/test_lifecycle.py`` (DESIGN.md §13). Both packages get
the same particles, made from a seed with numpy (the tiny linear module
of those files), or the reference's weights carried over as numpy (the
2-layer tiny qwen of ``tests/test_speculative.py``, the 2-layer tiny ViT
of ``tests/test_torch_train.py``). Checks and their tolerances:

  * the presets, ``key()`` and ``describe()`` equal to the reference's;
  * ``quantize_int8`` / ``dequantize`` / ``cast_for_serve`` bit for bit
    against the reference's on a stacked tiny-qwen tree (its 3-D biases
    and norm scales packed too, one scale spanning every unit), and the
    in-place forms equal to the new-tree forms;
  * training under "mixed": losses track fp32 within the reference's bar
    (|d| < 0.1 |fp32| + 0.05), masters stay fp32, NEL vs compiled under
    1e-4; fp32 masters accumulate 50 steps of 1e-3 (below bf16 spacing)
    while bf16 masters stall; a mixed step against the reference's within
    2e-2 of the params (one bf16 rounding of the grads: the two packages
    round the same products, but XLA's CPU backend may keep excess
    precision across a chain of bf16 ops where torch rounds after each);
    the ViT's mixed loss and grads against the reference's, 5e-2
    relative; a bf16-master SWAG collection against the reference's
    kernel path within 1e-5 (fp32 moments, a bf16 ring, as the
    reference's state has after its first collection);
  * precision as a cache-key dimension (fp32 specs carry None);
    ``param_footprint`` halving; ``tree_bytes``; the store's
    master-dtype bytes;
  * serving: heads within 0.03 ("mixed") and 0.06 ("mixed_int8") of the
    fp32 members (the reference's bars) and within 2e-2 of the
    reference's heads under the same policy; the serve copy keeps its
    addresses across commits and churn, captures nothing after warmup,
    and a clone's row is the bf16 cast of its master exactly;
  * LM serving: "mixed" (fp32 arithmetic from bf16 weights, bit-equal on
    both sides) token-exact with the reference's "mixed" serving, plain
    and speculative with the fp32 and the int8 draft (logprobs 1e-4), the
    int8 draft with the reference's drafted and accepted counts; the
    int8 draft's pack equal to the reference's ``quantize_int8`` of the
    draft row, before and after the drafter's kill; a "bf16" store stays token-stable across churn with
    no capture; a bf16 ``cfg.dtype`` step, teacher-forced along a
    prompt: member logits within 3e-2 and BMA probabilities within 1e-2
    of the reference's largest (the two implementations round bf16
    differently, and random tiny models give flat distributions, ~1e-2
    each over 128 tokens), greedy tokens equal wherever the reference's
    top-2 gap exceeds 1e-2 of its top probability.

Left for later queue items: the checkpoint round trips (item 8a), the
remat policies (item 13), ``pick_model_axis`` (item 10).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bdl.swag import swag_collect as jswag_collect
from repro.bdl.swag import swag_state_init as jswag_state_init
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.core import precision as jprec
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro.runtime import global_cache as jglobal_cache
from repro.runtime import specs as jspecs
from repro.serve import PredictiveEngine as JPredictiveEngine
from repro.serve import SpecConfig as JSpecConfig
from repro.serve import serve_decode as jserve_decode
from repro_torch import configs as tconfigs
from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
from repro_torch.bdl.swag import swag_collect, swag_state_init
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core import precision as tprec
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models.blocks import dense_apply
from repro_torch.optim import adam, sgd
from repro_torch.runtime import ProgramCache, specs
from repro_torch.serve import PredictiveEngine, SpecConfig, serve_decode
from test_torch_speculative import _cfgs as _lm_cfgs
from test_torch_speculative import _jax_stacked, _paths, _to_port
from test_torch_train import _cfgs as _vit_cfgs

PRESETS = ("fp32", "mixed", "bf16", "mixed_int8")


@functools.lru_cache(maxsize=None)
def _lm_stacked():
    """The reference's two tiny-qwen particles as numpy (made once)."""
    jcfg = _lm_cfgs()[0]
    return jax.tree.map(np.asarray,
                        jax.jit(functools.partial(_jax_stacked, jcfg))())


# ---------------------------------------------------------------------------
# the tiny linear module of tests/test_precision.py, in both packages
# ---------------------------------------------------------------------------

def _inits(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((3, 4)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(4) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _tfwd(p, b):
    return torch.einsum("bi,pij->pbj", b[0].to(p["w"].dtype),
                        p["w"]) + p["b"][:, None]


def _tloss(p, b):
    return ((_tfwd(p, b) - b[1].to(p["w"].dtype)) ** 2).mean((1, 2)), {}


def _modules(inits):
    jit, tit = iter(inits), iter(inits)
    jmod = JModule(lambda rng: jax.tree.map(jnp.asarray, next(jit)),
                   lambda p, b: (jnp.mean((b[0] @ p["w"] + p["b"]
                                           - b[1]) ** 2), {}),
                   lambda p, b: b[0] @ p["w"] + p["b"])
    tmod = ParticleModule(lambda gen: params_from_numpy(next(tit)), _tloss,
                          _tfwd)
    return jmod, tmod


def _batch(m=8, seed=3):
    x = np.random.default_rng(seed).standard_normal((m, 3)).astype(
        np.float32)
    return x, x @ np.ones((3, 4), np.float32)


def _tb(b):
    return tuple(torch.from_numpy(np.array(x)) for x in b)


def _stacked(n=4, seed=0):
    return {k: torch.from_numpy(np.stack([i[k] for i in _inits(n, seed)]))
            for k in ("w", "b")}


def _pd(policy, n=4, capacity=4, backend="compiled", opt=None):
    _, tmod = _modules(_inits(n))
    pd = PushDistribution(tmod, capacity=capacity, backend=backend,
                          precision=policy, device="cpu")
    for _ in range(n):
        pd.p_create(opt or sgd(0.1))
    pd.runtime.cache = ProgramCache()
    return pd


# ---------------------------------------------------------------------------
# the policy object
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
def test_presets_keys_and_describe_equal_the_reference(name):
    t, j = tprec.get(name), jprec.get(name)
    assert t.key() == j.key()
    assert t.describe() == j.describe()
    assert (t.casts_compute, t.casts_serve) == (j.casts_compute,
                                                j.casts_serve)
    assert tprec.dtype_name(t.master) == str(j.master)
    assert tprec.dtype_name(t.serve) == str(j.serve)


def test_get_resolves_presets_and_refuses_the_rest():
    assert tprec.get(None) == tprec.PRESETS["fp32"]
    p = tprec.get("mixed")
    assert tprec.get(p) is p
    assert tprec.get("bf16").master == torch.bfloat16
    assert tprec.get("mixed_int8").serve_quant == "int8"
    assert len({tprec.get(n).key() for n in PRESETS}) == len(PRESETS)
    with pytest.raises(ValueError, match="unknown precision preset"):
        tprec.get("fp8_dreams")
    with pytest.raises(TypeError):
        tprec.get(3)
    with pytest.raises(ValueError):
        tprec.Precision(master_dtype="float33")
    with pytest.raises(ValueError):
        tprec.Precision(serve_quant="int4")


# ---------------------------------------------------------------------------
# int8 packs and casts: bit for bit against the reference
# ---------------------------------------------------------------------------

def _qwen_tree(dtype=np.float32):
    stacked = jax.tree.map(lambda a: a.astype(dtype), _lm_stacked())
    return stacked, params_from_numpy(stacked)


def _same_bits(t, j):
    got, want = dict(_paths(t)), dict(_paths(jax.tree.map(np.asarray, j)))
    assert set(got) == set(want)
    for path, leaf in got.items():
        w = want[path]
        if leaf.dtype == torch.bfloat16:
            assert str(w.dtype) == "bfloat16", path
            assert np.array_equal(leaf.view(torch.int16).numpy(),
                                  w.view(np.int16)), path
        else:
            assert leaf.numpy().dtype == w.dtype, path
            assert np.array_equal(leaf.numpy(), w), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_equal_on_a_stacked_qwen_tree(dtype):
    import ml_dtypes
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jtree, ttree = _qwen_tree(np_dtype)
    jq = jprec.quantize_int8(jax.tree.map(jnp.asarray, jtree))
    tq = tprec.quantize_int8(ttree)
    _same_bits(tq, jq)
    # 3-D biases and norm scales are packed, one scale across the units
    unit = tq["units"][0]
    assert tprec.is_quantized_leaf(unit["ln1"]["scale"])
    assert tprec.is_quantized_leaf(unit["attn"]["wq"]["b"])
    assert unit["attn"]["wq"]["w"]["s"].shape == (2, 1, 1, 32)
    assert not tprec.is_quantized_leaf(tq["final_norm"]["scale"])
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        _same_bits(tprec.dequantize(tq, tdt), jprec.dequantize(jq, dt))
    # the in-place form writes the same values into persistent buffers
    out = tprec.quantize_int8_like(ttree)
    row = tree_map(lambda a: torch.empty_like(a, dtype=torch.bfloat16),
                   ttree)
    tprec.quantize_int8_into(out, ttree, row)
    _same_bits(out, jq)
    _same_bits(row, jprec.dequantize(jq, jnp.bfloat16))
    # a wider row holds the bf16 values exactly (the int8 draft's fp32 row)
    wide = tree_map(lambda a: torch.empty_like(a, dtype=torch.float32),
                    ttree)
    tprec.quantize_int8_into(out, ttree, wide, dtype=torch.bfloat16)
    _same_bits(wide, jax.tree.map(lambda a: a.astype(jnp.float32),
                                  jprec.dequantize(jq, jnp.bfloat16)))


@pytest.mark.parametrize("policy", ["mixed", "mixed_int8", "bf16"])
def test_cast_for_serve_bit_equal_and_in_place(policy):
    jtree, ttree = _qwen_tree()
    want = jprec.cast_for_serve(jax.tree.map(jnp.asarray, jtree), policy)
    got = tprec.cast_for_serve(ttree, policy)
    _same_bits(got, want)
    copy = tprec.serve_copy_like(ttree, policy)
    ptrs = [x.data_ptr() for x in tree_leaves(copy)]
    tprec.cast_for_serve_into(copy, ttree)
    _same_bits(copy, want)
    assert [x.data_ptr() for x in tree_leaves(copy)] == ptrs


def test_int8_roundtrip_error_bounded():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 8)).astype(np.float32) * 0.5)
    q = tprec.quantize_int8({"w": w})["w"]
    assert q["q"].dtype == torch.int8 and q["s"].shape == (2, 1, 8)
    back = tprec.dequantize({"w": q}, torch.float32)["w"]
    amax = w.abs().amax(dim=1, keepdim=True)
    assert float((back - w).abs().max()) <= float((amax / 254 + 1e-7).max())


def test_dense_apply_runs_a_packed_weight():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((2, 5, 3)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4, 5)).astype(np.float32))
    pack = tprec.quantize_int8({"w": w})["w"]
    got = dense_apply({"w": pack}, x)
    want = dense_apply({"w": tprec.dequantize(pack, torch.float32)}, x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# training under the ladder
# ---------------------------------------------------------------------------

def _run_steps(policy, steps=5, opt=None):
    opt = opt or sgd(0.05)
    params = _stacked()
    params = tprec.cast_floats(params, tprec.get(policy).master)
    state = opt.init(params)
    state["step"] = torch.zeros(4, dtype=torch.int32)
    spec = specs.ensemble_step(_tloss, opt, precision=policy)
    cache = ProgramCache()
    mask = torch.ones(4)
    for _ in range(steps):
        params, state, losses = cache.run(spec, params, state, _tb(_batch()),
                                          mask)
    return params, losses


def test_mixed_compute_tracks_fp32_and_keeps_fp32_masters():
    finals = {}
    for name in ("fp32", "mixed"):
        params, losses = _run_steps(name)
        assert all(x.dtype == torch.float32 for x in tree_leaves(params))
        assert losses.dtype == torch.float32
        finals[name] = float(losses.mean())
    assert abs(finals["mixed"] - finals["fp32"]) < \
        0.1 * abs(finals["fp32"]) + 0.05
    # against the reference's mixed step on the same particles
    jparams = jax.tree.map(jnp.asarray, {k: v.numpy()
                                         for k, v in _stacked().items()})
    opt = jsgd(0.05)
    jstate = jax.vmap(opt.init)(jparams)
    spec = jspecs.ensemble_step(
        lambda p, b: (jnp.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2), {}),
        opt, precision="mixed")
    jb = tuple(jnp.asarray(x) for x in _batch())
    for _ in range(5):
        jparams, jstate, jl = jglobal_cache().run(spec, jparams, jstate, jb,
                                                  jnp.ones((4,)))
    tparams, _ = _run_steps("mixed")
    for k in ("w", "b"):
        assert np.abs(tparams[k].numpy() - np.asarray(jparams[k])).max() \
            < 2e-2


def test_fp32_masters_accumulate_below_bf16_spacing():
    def loss(p, b):
        return 1e-3 * p["w"].sum(-1), {}

    out = {}
    for name in ("mixed", "bf16"):
        opt = sgd(1.0)
        params = tprec.cast_floats({"w": torch.ones(2, 4)},
                                   tprec.get(name).master)
        state = opt.init(params)
        state["step"] = torch.zeros(2, dtype=torch.int32)
        spec = specs.ensemble_step(loss, opt, precision=name)
        cache = ProgramCache()
        for _ in range(50):
            params, state, _ = cache.run(spec, params, state,
                                         (torch.zeros(1),), torch.ones(2))
        out[name] = params["w"].float()
    assert torch.all(out["bf16"] == 1.0), "bf16 masters must stall"
    assert float((out["mixed"] - 0.95).abs().max()) < 2e-3


def test_nel_and_compiled_agree_under_mixed():
    data = [_batch()]
    preds = {}
    for be in ("nel", "compiled"):
        _, tmod = _modules(_inits(4))
        with DeepEnsemble(tmod, seed=0, backend=be, precision="mixed",
                          device="cpu") as de:
            de.bayes_infer(data, 5, optimizer=adam(1e-2), num_particles=4)
            for pid in de.push_dist.particle_ids():
                assert de.push_dist.particles[pid].compute_dtype \
                    == torch.bfloat16
                assert de.push_dist.p_params(pid)["w"].dtype == torch.float32
            preds[be] = de.push_dist.p_predict(_tb(data[0])).numpy()
    assert np.abs(preds["nel"] - preds["compiled"]).max() < 1e-4


def test_precision_is_a_cache_key_dimension():
    opt = sgd(0.1)
    params = _stacked()
    state = opt.init(params)
    state["step"] = torch.zeros(4, dtype=torch.int32)
    args = (params, state, _tb(_batch()), torch.ones(4))
    s_fp32 = specs.ensemble_step(_tloss, opt)
    s_mixed = specs.ensemble_step(_tloss, opt, precision="mixed")
    assert s_fp32.precision is None
    assert s_mixed.precision == tprec.get("mixed").key() \
        == jprec.get("mixed").key()
    from repro_torch.bdl.svgd import svgd_step_spec
    assert svgd_step_spec(_tloss, lr=0.1).precision is None
    assert svgd_step_spec(_tloss, lr=0.1, precision="mixed").precision \
        == tprec.get("mixed").key()
    cache = ProgramCache()
    cache.lookup(s_fp32, args)
    cache.lookup(s_mixed, args)                 # same args, another key
    cache.lookup(s_mixed, args)                 # warm
    st = cache.snapshot_stats()
    assert (st["misses"], st["hits"], st["programs"]) == (2, 1, 2)


def test_bf16_store_casts_masters_and_optimizer_state_follows():
    pd = _pd("bf16", n=2, opt=adam(1e-2))
    try:
        pid = pd.particle_ids()[0]
        assert all(x.dtype == torch.bfloat16
                   for x in tree_leaves(pd.p_params(pid)))
        st = pd.particles[pid].state["opt_state"]
        assert st["m"]["w"].dtype == torch.bfloat16
        assert pd.particles[pid].compute_dtype is None    # no cast
        twin = pd.p_clone(pid)
        assert torch.equal(pd.p_params(twin)["w"], pd.p_params(pid)["w"])
    finally:
        pd.cleanup()
    pd = _pd("mixed", n=1)
    try:
        twin = pd.p_clone(pd.particle_ids()[0])
        assert pd.particles[twin].compute_dtype == torch.bfloat16
    finally:
        pd.cleanup()


def test_param_footprint_halves_and_equals_the_reference():
    jcfg, tcfg = _lm_cfgs()
    f32, bf16 = tapi.param_footprint(tcfg), tapi.param_footprint(tcfg, "bf16")
    assert f32 == 2 * bf16 == japi.param_footprint(jcfg)
    assert bf16 == japi.param_footprint(jcfg, "bf16")
    assert tapi.param_footprint(tconfigs.get("qwen1.5-0.5b")) \
        == 4 * 463_987_712


def test_tree_bytes_counts_floats_at_master_itemsize():
    tree = {"w": torch.zeros(8, 4), "step": torch.zeros((), dtype=torch.int32)}
    assert tprec.tree_bytes(tree) == 8 * 4 * 4 + 4
    assert tprec.tree_bytes(tree, "bf16") == 8 * 4 * 2 + 4


def test_store_reports_master_dtype_bytes():
    per = {}
    for name in ("fp32", "bf16"):
        pd = _pd(name, n=1)
        try:
            per[name] = pd.store.per_particle_bytes("params")
            assert pd.store.precision.master == tprec.get(name).master
        finally:
            pd.cleanup()
    assert per["fp32"] == 2 * per["bf16"] == (12 + 4) * 4


def test_vit_mixed_loss_and_grads_track_the_reference():
    jcfg, tcfg = _vit_cfgs()
    jparams = jax.vmap(lambda k: japi.init_params(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    tparams = _to_port(jparams)
    rng = np.random.default_rng(0)
    batch = {"images": rng.random((6, 28, 28, 1), np.float32),
             "labels": rng.integers(0, 10, 6).astype(np.int32)}
    cast = jprec.cast_floats

    def jloss(p, b):
        return japi.loss_fn(cast(p, jnp.bfloat16), cast(b, jnp.bfloat16),
                            jcfg)[0]

    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jloss), in_axes=(0, None)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tl, tg = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg), torch.bfloat16)(
        tparams, tree_map(torch.from_numpy, batch))
    assert tl.dtype == torch.float32
    assert tg["head"]["w"].dtype == torch.float32
    assert np.abs(tl.numpy() - np.asarray(jl, np.float32)).max() \
        < 5e-2 * np.abs(np.asarray(jl, np.float32)).max()
    want = dict(_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), jg)))
    for path, g in _paths(tg):
        scale = np.abs(want[path]).max() + 1e-3
        assert np.abs(g.numpy() - want[path]).max() < 5e-2 * scale, path


def test_fused_svgd_mixed_and_multiswag_bf16_train():
    jcfg, tcfg = _vit_cfgs()
    from repro_torch.data import DataLoader
    from test_torch_train import _modules as _vit_modules
    from test_torch_train import _numpy_inits
    def loader():       # a loader's stream goes on across its passes
        return DataLoader(tcfg, batch_size=8, num_batches=2, seed=0)

    losses = {}
    for name in ("fp32", "mixed"):
        _, tmod = _vit_modules(jcfg, tcfg, _numpy_inits(jcfg, 3))
        with SteinVGD(tmod, backend="compiled", precision=name,
                      device="cpu") as algo:
            algo.push_dist.runtime.cache = ProgramCache()
            _, ls = algo.bayes_infer(loader(), 2, num_particles=3, lr=0.05)
            pid = algo.push_dist.particle_ids()[0]
            assert algo.push_dist.p_params(pid)["head"]["w"].dtype \
                == torch.float32
            losses[name] = np.asarray(ls)
    assert np.all(np.abs(losses["mixed"] - losses["fp32"])
                  < 0.1 * np.abs(losses["fp32"]) + 0.05)
    _, tmod = _vit_modules(jcfg, tcfg, _numpy_inits(jcfg, 3))
    with MultiSWAG(tmod, backend="compiled", precision="bf16",
                   device="cpu") as algo:
        algo.push_dist.runtime.cache = ProgramCache()
        _, ls = algo.bayes_infer(loader(), 2, optimizer=adam(1e-3),
                                 num_particles=3, max_rank=3)
        assert np.all(np.isfinite(ls))
        pid = algo.push_dist.particle_ids()[0]
        assert algo.push_dist.p_params(pid)["head"]["w"].dtype \
            == torch.bfloat16
        swag = algo.store.dense("swag")
        assert swag["mean"]["head"]["w"].dtype == torch.float32
        assert swag["dev"]["head"]["w"].dtype == torch.bfloat16
        assert int(swag["rank"][0]) == 2
        assert algo.push_dist.runtime.cache.snapshot_stats()[
            "programs"] == 2


def test_bf16_swag_collection_matches_the_reference_kernel_path():
    import ml_dtypes
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal((3,)).astype(ml_dtypes.bfloat16)}
    jstate = jswag_state_init(jax.tree.map(jnp.asarray, tree), 3)
    tstate = tree_map(lambda x: x[None],
                      swag_state_init(params_from_numpy(tree), 3))
    for step in range(3):
        p = jax.tree.map(lambda a, s=step: (a.astype(np.float32) * (1 + s)
                                            ).astype(ml_dtypes.bfloat16),
                         tree)
        jstate = jswag_collect(jstate, jax.tree.map(jnp.asarray, p),
                               use_kernel=True, interpret=True)
        swag_collect(tstate, tree_map(lambda x: x[None],
                                      params_from_numpy(p)))
    for key in ("mean", "sq_mean", "dev"):
        for k in ("a", "b"):
            got = tstate[key][k][0]
            want = np.asarray(jstate[key][k])
            # the reference's moments turn fp32 at its first collection;
            # the port's are fp32 from the start; the ring stays bf16
            assert tprec.dtype_name(got.dtype) == str(want.dtype), (key, k)
            got, want = got.float().numpy(), want.astype(np.float32)
            assert np.abs(got - want).max() <= 1e-5 * (
                np.abs(want).max() + 1), (key, k)


# ---------------------------------------------------------------------------
# classification serving under the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,tol", [("mixed", 0.03), ("mixed_int8", 0.06)])
def test_serving_heads_match_fp32_members_and_the_reference(policy, tol):
    pd = _pd(policy)
    x = np.random.default_rng(5).standard_normal((6, 3)).astype(np.float32)
    try:
        eng = PredictiveEngine(pd.module.forward, store=pd.store,
                               kind="regress")
        assert eng.precision.casts_serve           # the store's policy
        heads = eng.predict((x, None))
        assert heads["mean"].dtype == torch.float32
        ref = np.mean([x @ pd.p_params(p)["w"].numpy()
                       + pd.p_params(p)["b"].numpy()
                       for p in pd.particle_ids()], 0)
        assert np.abs(heads["mean"].numpy() - ref).max() < tol
    finally:
        pd.cleanup()
    jmod, _ = _modules(_inits(4))
    with JPD(jmod, num_devices=1, capacity=4, precision=policy) as jpd:
        for _ in range(4):
            jpd.p_create(jsgd(0.1))
        jheads = JPredictiveEngine(jpd.module.forward, store=jpd.store,
                                   kind="regress").predict(
            (jnp.asarray(x), None))
    assert np.abs(heads["mean"].numpy()
                  - np.asarray(jheads["mean"])).max() < 2e-2


def test_bf16_serving_survives_churn_with_zero_captures():
    """``tests/test_lifecycle.py:327`` on the port: on a "mixed" store the
    serve copy is rewritten in place after every clone and kill, nothing
    is captured after the first predict, and a clone's row in the copy
    is the bf16 cast of its master."""
    pd = _pd("mixed")
    x = np.random.default_rng(9).standard_normal((8, 3)).astype(np.float32)
    try:
        eng = PredictiveEngine(pd.module.forward, store=pd.store,
                               kind="regress")
        eng.predict((x, None))
        copy = eng._mask_and_params()[1]
        ptrs = [t.data_ptr() for t in tree_leaves(copy)]
        misses = eng.cache.snapshot_stats()["misses"]
        for _ in range(3):
            pd.p_kill(pd.particle_ids()[0])
            twin = pd.p_clone(pd.particle_ids()[0], jitter=0.01)
            heads = eng.predict((x, None))
            ref = np.mean([x @ pd.p_params(p)["w"].numpy()
                           + pd.p_params(p)["b"].numpy()
                           for p in pd.particle_ids()], 0)
            assert np.abs(heads["mean"].numpy() - ref).max() < 0.05
            slot = pd.store.slot_of(twin)
            served = eng._mask_and_params()[1]
            assert served is copy
            assert torch.equal(served["w"][slot],
                               pd.p_params(twin)["w"].to(torch.bfloat16))
        assert [t.data_ptr() for t in tree_leaves(copy)] == ptrs
        assert eng.cache.snapshot_stats()["misses"] == misses
        names = [p["name"] for p in eng.cache.program_costs()]
        assert names.count("serve_cast") == 1
    finally:
        pd.cleanup()


def test_static_tree_is_packed_once_and_serves():
    pd = _pd("fp32")
    try:
        stacked = pd.store.stacked("params")
        x = np.random.default_rng(2).standard_normal((5, 3)).astype(
            np.float32)
        eng = PredictiveEngine(pd.module.forward, params=stacked,
                               kind="regress", precision="mixed_int8")
        served = eng._mask_and_params()[1]
        assert tprec.is_quantized_leaf(served["w"])
        assert served["b"].dtype == torch.bfloat16
        heads, outs = eng.predict((x, None), members=True)
        assert outs.dtype == torch.float32 and outs.shape == (4, 5, 4)
        full = PredictiveEngine(pd.module.forward, params=stacked,
                                kind="regress").predict((x, None))
        assert np.abs(heads["mean"].numpy()
                      - full["mean"].numpy()).max() < 0.06
    finally:
        pd.cleanup()


# ---------------------------------------------------------------------------
# LM serving under the ladder
# ---------------------------------------------------------------------------

PROMPTS_SEED = 0


def _prompts(vocab, n=3, seed=PROMPTS_SEED):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, int(rng.integers(4, 12)))))
            for _ in range(n)]


def _ref_serve(jcfg, stacked, prompts, max_new, policy, **kw):
    """The reference's generations and its service's stats."""
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    n = jax.tree.leaves(stacked)[0].shape[0]
    with JPD(module, num_devices=1, seed=0, precision=policy) as jpd:
        for i in range(n):
            jpd.p_create(params=jax.tree.map(lambda a: jnp.asarray(a[i]),
                                             stacked))
        svc = jserve_decode(jpd, jcfg, num_pages=32, page_size=8,
                            max_active=3, decode_kernel=False, warmup=False,
                            **kw)
        try:
            return [h.result(300) for h in
                    [svc.generate_async(p, max_new=max_new)
                     for p in prompts]], svc.stats()
        finally:
            svc.close()


def _port_lm_pd(tcfg, stacked, policy, capacity=0):
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg),
                          capacity=capacity, precision=policy, device="cpu")
    n = jax.tree.leaves(stacked)[0].shape[0]
    for i in range(n):
        pd.p_create(params=_to_port(jax.tree.map(lambda a: a[i], stacked)))
    return pd


def _port_serve(pd, tcfg, prompts, max_new, **kw):
    svc = serve_decode(pd, tcfg, num_pages=32, page_size=8, max_active=3,
                       **kw)
    try:
        gens = [h.result(300) for h in
                [svc.generate_async(p, max_new=max_new) for p in prompts]]
        return gens, svc.stats()
    finally:
        svc.close()


def test_mixed_lm_serving_token_exact_with_the_reference():
    """"mixed" serving reads the bf16 serve copy but computes in fp32 (the
    config's dtype) on both sides, from bit-equal bf16 weights: plain,
    speculative and int8-draft serving all give the reference's "mixed"
    tokens, and the int8 draft drafts what the reference's drafts: the
    same drafted and accepted token counts (verify corrects any draft, so
    the tokens alone would not show a wrong one)."""
    jcfg, tcfg = _lm_cfgs()
    stacked = _lm_stacked()
    prompts = _prompts(jcfg.vocab_size)
    want, _ = _ref_serve(jcfg, stacked, prompts, 5, "mixed")
    want_q, jst = _ref_serve(jcfg, stacked, prompts, 5, "mixed",
                             speculative=JSpecConfig(k_max=3,
                                                     quantized=True))
    assert [g.tokens for g in want_q] == [g.tokens for g in want]
    jss = jst["speculative"]
    assert jss["drafted_tokens"] > jss["accepted_tokens"] > 0
    pd = _port_lm_pd(tcfg, stacked, "mixed")
    try:
        for spec in (None, True, SpecConfig(k_max=3, quantized=True)):
            gens, st = _port_serve(pd, tcfg, prompts, 5, speculative=spec,
                                   warmup_buckets=(8, 16))
            for a, b in zip(want, gens):
                assert a.tokens == b.tokens, spec
                np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)
            assert st["pool"]["used_pages"] == 0
            assert st["engine"]["program_cache"]["misses"] == \
                st["engine"]["program_cache"]["cold_compiles"]
            if isinstance(spec, SpecConfig):
                assert st["engine"]["draft_packs"] >= 1
                ss = st["speculative"]
                assert ss["quantized"] is True
                assert (ss["drafted_tokens"], ss["accepted_tokens"]) == \
                    (jss["drafted_tokens"], jss["accepted_tokens"])
    finally:
        pd.cleanup()


def test_int8_draft_row_follows_the_draft_slot_after_a_kill():
    """The int8 draft's pack is the reference's ``quantize_int8`` of the
    draft slot's serve-copy row, bit for bit, and its row that pack's
    bf16 dequantization held in the config's fp32; killing the drafter
    moves the draft to the next live slot, whose row is packed anew (one
    more ``draft_packs``) with nothing captured."""
    jcfg, tcfg = _lm_cfgs()
    stacked = _lm_stacked()
    prompts = _prompts(jcfg.vocab_size)
    pd = _port_lm_pd(tcfg, stacked, "mixed", capacity=4)
    try:
        svc = serve_decode(pd, tcfg, num_pages=32, page_size=8,
                           max_active=3, warmup_buckets=(8, 16),
                           speculative=SpecConfig(k_max=2, quantized=True))
        try:
            eng = svc.engine

            def check(slot):
                pack, row = eng._pack[0], eng._pack[1]
                assert all(x.dtype == torch.float32
                           for x in tree_leaves(row))
                jrow = jax.tree.map(lambda a: jnp.asarray(
                    a[slot:slot + 1]).astype(jnp.bfloat16), stacked)
                jpack = jprec.quantize_int8(jrow)
                _same_bits(pack, jpack)
                _same_bits(row, jax.tree.map(
                    lambda a: a.astype(jnp.float32),
                    jprec.dequantize(jpack, jnp.bfloat16)))

            svc.generate(prompts[0], max_new=3)
            assert eng.pick_draft_slot(eng.active_mask()) == 0
            check(0)
            packs = eng.stats["draft_packs"]
            misses = svc.stats()["misses"]
            with svc.scheduler.step_lock:
                pd.p_kill(pd.particle_ids()[0])
            svc.generate(prompts[1], max_new=3)
            assert eng.pick_draft_slot(eng.active_mask()) == 1
            check(1)
            assert eng.stats["draft_packs"] == packs + 1
            assert svc.stats()["misses"] == misses
        finally:
            svc.close()
    finally:
        pd.cleanup()


def test_quantized_draft_token_exact_and_rollback_under_fp32():
    """``tests/test_speculative.py:237`` on the port: an fp32 store, the
    int8 draft dequantized to fp32; tokens equal the reference's plain
    scheduler, rejected windows roll back, the pool drains."""
    jcfg, tcfg = _lm_cfgs()
    stacked = _lm_stacked()
    prompts = _prompts(jcfg.vocab_size, seed=1)
    want, _ = _ref_serve(jcfg, stacked, prompts, 6, None)
    pd = _port_lm_pd(tcfg, stacked, None)
    try:
        gens, st = _port_serve(pd, tcfg, prompts, 6, warmup=False,
                               speculative=SpecConfig(k_max=3,
                                                      quantized=True))
    finally:
        pd.cleanup()
    for a, b in zip(want, gens):
        assert a.tokens == b.tokens
    assert st["engine"]["draft_packs"] >= 1
    assert st["speculative"]["quantized"] is True
    assert st["pool"]["used_pages"] == 0
    assert st["engine"]["slot_uploads"] >= 1


def test_bf16_decode_serving_steady_state_captures_nothing():
    """``tests/test_lifecycle.py:358`` on the port: a "bf16" store (bf16
    masters, the config's fp32 arithmetic); steady state and a clone/kill
    round trip capture nothing and give the same tokens, which equal the
    reference's under the same policy."""
    jcfg, tcfg = _lm_cfgs()
    stacked = _lm_stacked()
    prompt = [3, 5, 7, 11, 13]
    want = _ref_serve(jcfg, stacked, [prompt], 4, "bf16")[0][0]
    pd = _port_lm_pd(tcfg, stacked, "bf16", capacity=4)
    try:
        for p in pd.particle_ids():
            assert all(x.dtype == torch.bfloat16
                       for x in tree_leaves(pd.p_params(p)))
        svc = serve_decode(pd, tcfg, num_pages=16, page_size=8,
                           max_active=2, warmup_buckets=(8,))
        try:
            base = svc.generate(prompt, max_new=4)
            assert base.tokens == want.tokens
            misses = svc.stats()["misses"]
            assert svc.generate(prompt, max_new=4).tokens == base.tokens
            with svc.scheduler.step_lock:
                twin = pd.p_clone(pd.particle_ids()[0], jitter=0.01)
            svc.generate(prompt, max_new=4)
            with svc.scheduler.step_lock:
                pd.p_kill(twin)
            back = svc.generate(prompt, max_new=4)
            assert back.tokens == base.tokens
            assert svc.stats()["misses"] == misses
        finally:
            svc.close()
    finally:
        pd.cleanup()


def test_bf16_config_step_probabilities_track_the_reference():
    """Under a bf16 ``cfg.dtype`` both packages compute in bf16, and the
    two implementations round differently (module doc): one
    teacher-forced paged decode step per position of a prompt, BMA
    probabilities within 2e-2; greedy tokens equal wherever the
    reference's top-2 margin exceeds that."""
    jcfg, tcfg = _lm_cfgs()
    jcfg, tcfg = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    stacked = _lm_stacked()
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                           stacked)
    tparams = tprec.cast_floats(_to_port(stacked), torch.bfloat16)
    prompt = _prompts(jcfg.vocab_size, n=1, seed=3)[0]
    ps, npg = 8, 4
    jpages = jax.vmap(lambda _: japi.paged_cache_init(
        jcfg, num_pages=npg, page_size=ps))(jnp.arange(2))
    tpages = tree_map(lambda a: torch.zeros((2,) + tuple(a.shape),
                                            dtype=a.dtype),
                      tapi.paged_cache_init(tcfg, num_pages=npg,
                                            page_size=ps, device="cpu"))
    bt = np.arange(npg, dtype=np.int32)[None]
    tol, checked = 1e-2, 0
    jstep = jax.jit(jax.vmap(
        lambda p, pg, tok, sl: japi.decode_step_paged(
            p, tok, pg, jnp.asarray(bt), sl, jcfg, decode_kernel=False),
        in_axes=(0, 0, None, None)))
    for pos, tok in enumerate(prompt):
        tok_a = np.asarray([tok], np.int32)
        sl = np.asarray([pos], np.int32)
        jl, jpages = jstep(jparams, jpages, jnp.asarray(tok_a),
                           jnp.asarray(sl))
        tl, tpages = tapi.decode_step_paged(
            tparams, torch.from_numpy(tok_a), tpages, torch.from_numpy(bt),
            torch.from_numpy(sl), tcfg)
        jl = np.asarray(jl, np.float32)
        assert np.abs(tl.float().numpy() - jl).max() < \
            3 * tol * np.abs(jl).max(), pos
        jp = np.asarray(jax.nn.softmax(jnp.asarray(jl), -1)).mean(0)[0]
        tp = torch.softmax(tl.float(), -1).mean(0)[0].numpy()
        assert np.abs(jp - tp).max() < tol * jp.max(), pos
        top2 = np.sort(jp)[-2:]
        if top2[1] - top2[0] > tol * jp.max():
            assert int(jp.argmax()) == int(tp.argmax()), pos
            checked += 1
    assert checked >= 3
