"""The port's serving slice against the JAX package, on the CPU.

Both packages run the same weights: the reference initializes them and
they cross over as numpy through ``repro_torch.interop.params_from_numpy``.
Checks, at a tiny width (2 layers, d_model 64, GQA 4/2, vocab 512):

  * the carried-over tree keeps the reference's key paths and shapes, and
    the port's own init builds the same paths and shapes;
  * paged prefill + decode steps: logits within 1e-4, pages within 1e-5;
  * ``serve_decode`` end to end with P = 2 against the JAX ``serve_decode``
    (``decode_kernel=False``), under teacher forcing: per-step logprob,
    entropy and mutual information within 1e-4, and tokens equal wherever
    the reference's top-2 BMA margin exceeds 1e-5;
  * the same on a pool small enough that rows are preempted and replayed;
  * the host page pool, the predictive heads and the bucketing helpers;
  * the port imports neither ``jax`` nor ``repro``.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.runtime import bucketing as jbucketing
from repro.serve import PagePool as JPagePool
from repro.serve import serve_decode as jserve_decode
from repro.serve import uncertainty as junc
from repro_torch import configs as tconfigs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.runtime import bucketing as tbucketing
from repro_torch.serve import PagePool, serve_decode
from repro_torch.serve import uncertainty as tunc

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, max_seq_len=128)


def _cfgs():
    return (jconfigs.get("qwen1.5-0.5b").replace(**TINY),
            tconfigs.get("qwen1.5-0.5b").replace(**TINY))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _stacked_jax_params(jcfg, n):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return jax.vmap(lambda k: japi.init_params(k, jcfg))(keys)


@pytest.mark.parametrize("variant", ["full", "smoke", "tiny"])
def test_config_fields_match_jax(variant):
    """Every field the port's config carries equals the reference's."""
    j, t = jconfigs.get("qwen1.5-0.5b"), tconfigs.get("qwen1.5-0.5b")
    if variant == "smoke":
        j, t = j.smoke(), t.smoke()
    elif variant == "tiny":
        j, t = _cfgs()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.hd, t.n_layers) == (j.hd, j.n_layers)


def test_params_from_numpy_key_paths_and_shapes():
    jcfg, tcfg = _cfgs()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    want = _jax_paths(jparams)
    got = dict(_paths(params_from_numpy(jax.tree.map(np.asarray, jparams))))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert isinstance(leaf, torch.Tensor)
        assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path
    # the port's own init builds the very same tree layout
    own = dict(_paths(tapi.init_params(torch.Generator().manual_seed(0),
                                       tcfg)))
    assert {p: tuple(t.shape) for p, t in own.items()} == \
        {p: tuple(np.shape(x)) for p, x in want.items()}


def test_paged_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    P, ps, NP, n_pmax = 2, 8, 16, 6
    stacked = _stacked_jax_params(jcfg, P)
    tparams = params_from_numpy(jax.tree.map(np.asarray, stacked))
    jpages = jax.vmap(lambda _: japi.paged_cache_init(
        jcfg, num_pages=NP, page_size=ps))(jnp.arange(P))
    tpages = tree_map(lambda a: torch.zeros((P,) + tuple(a.shape[1:])),
                      params_from_numpy(jax.tree.map(np.asarray, jpages)))
    rng = np.random.default_rng(5)
    lens = [13, 5]
    bts = np.array([[2, 3, 4, 0, 0, 0], [9, 10, 0, 0, 0, 0]], np.int32)
    toks = []
    for row, L in enumerate(lens):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :L] = rng.integers(1, jcfg.vocab_size, L)
        jl, jpages = jax.vmap(lambda p, pg: japi.prefill_paged(
            p, jnp.asarray(prompt), pg, jnp.asarray(bts[row]), jnp.int32(L),
            jcfg))(stacked, jpages)
        tl, tpages = tapi.prefill_paged(tparams, torch.from_numpy(prompt),
                                        tpages, torch.from_numpy(bts[row]),
                                        L, tcfg)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4
        toks.append(int(np.argmax(np.asarray(jl).mean(0)[0])))
    # three rows: two live sequences and an inactive one
    bt = np.concatenate([bts, np.zeros((1, n_pmax), np.int32)])
    tok = np.array(toks + [7], np.int32)
    sl = np.array(lens + [-1], np.int32)
    for _ in range(3):
        jl, jpages = jax.vmap(lambda p, pg: japi.decode_step_paged(
            p, jnp.asarray(tok), pg, jnp.asarray(bt), jnp.asarray(sl), jcfg,
            decode_kernel=False))(stacked, jpages)
        tl, tpages = tapi.decode_step_paged(
            tparams, torch.from_numpy(tok), tpages, torch.from_numpy(bt),
            torch.from_numpy(sl), tcfg)
        jl = np.asarray(jl)
        assert np.abs(jl[:, :2] - tl.numpy()[:, :2]).max() < 1e-4
        want = dict(_paths(jax.tree.map(np.asarray, jpages)))
        for path, leaf in _paths(tpages):
            assert np.abs(leaf.numpy() - want[path]).max() < 1e-5, path
        tok = np.array(list(np.argmax(jl.mean(0)[:2], -1)) + [7], np.int32)
        sl = sl + np.array([1, 1, 0], np.int32)


def _jax_margin(stacked, jcfg, tokens):
    """Top-2 gap of the reference's BMA next-token probabilities."""
    toks = jnp.asarray([tokens], jnp.int32)
    first, _ = jax.vmap(lambda p: japi.prefill(p, {"tokens": toks}, jcfg))(
        stacked)
    probs = np.sort(np.asarray(
        jnp.mean(jax.nn.softmax(first.astype(jnp.float32), -1), 0)[0]))
    return float(probs[-1] - probs[-2])


def _jax_serve(jcfg, prompts, max_new, **kw):
    """The reference's serve_decode over 2 particles (plain attention):
    (stacked params, generations, stats)."""
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0) as jpd:
        for _ in range(2):
            jpd.p_create()
        stacked = jpd.store.stacked("params")
        jsvc = jserve_decode(jpd, jcfg, decode_kernel=False, warmup=False,
                             **kw)
        try:
            jgens = [h.result(300) for h in
                     [jsvc.generate_async(p, max_new=max_new)
                      for p in prompts]]
            jstats = jsvc.stats()
        finally:
            jsvc.close()
    return stacked, jgens, jstats


def _port_pd(tcfg, stacked):
    """A CPU PushDistribution holding the reference's particles."""
    tparams = params_from_numpy(jax.tree.map(np.asarray, stacked))
    tpd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(2):
        tpd.p_create(params=tree_map(lambda a: a[p], tparams))
    return tpd


def test_serve_decode_matches_jax_teacher_forced():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, jcfg.vocab_size, int(rng.integers(3, 15))))
               for _ in range(4)]
    max_new = 6
    stacked, jgens, _ = _jax_serve(jcfg, prompts, max_new, num_pages=32,
                                   page_size=8, max_active=3)
    tsvc = serve_decode(_port_pd(tcfg, stacked), tcfg, num_pages=32,
                        page_size=8, max_active=3)
    compared = forced = 0
    try:
        for prompt, jg in zip(prompts, jgens):
            done = 0                 # reference steps checked so far
            while done < max_new:
                tg = tsvc.generate(prompt + jg.tokens[:done],
                                   max_new=max_new - done, timeout=300)
                for i, t in enumerate(tg.tokens):
                    k = done + i
                    assert abs(tg.entropy[i] - jg.entropy[k]) < 1e-4
                    assert abs(tg.mutual_info[i] - jg.mutual_info[k]) < 1e-4
                    compared += 1
                    if t != jg.tokens[k]:
                        # a near-tie: the reference's margin is within 1e-5
                        assert _jax_margin(stacked, jcfg,
                                           prompt + jg.tokens[:k]) <= 1e-5
                        forced += 1
                        break
                    assert abs(tg.logprobs[i] - jg.logprobs[k]) < 1e-4
                done = k + 1
    finally:
        tsvc.close()
    assert compared == len(prompts) * max_new
    assert forced <= 1


def test_serve_decode_preemption_matches_jax():
    """A pool too small for the load (3 rows that grow to 5 pages each, 8
    pages) preempts the youngest row on both sides. A preempted row is
    replayed: one prefill over all_tokens[:-1], whose own token is dropped.
    Per-step entropy and mutual information match the reference within
    1e-4, and tokens and logprobs too up to a near-tie."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, jcfg.vocab_size, 12)) for _ in range(3)]
    max_new, kw = 8, dict(num_pages=8, page_size=4, max_active=3)
    stacked, jgens, jstats = _jax_serve(jcfg, prompts, max_new, **kw)
    tsvc = serve_decode(_port_pd(tcfg, stacked), tcfg, warmup=False, **kw)
    try:
        tgens = [h.result(300) for h in
                 [tsvc.generate_async(p, max_new=max_new) for p in prompts]]
        tstats = tsvc.stats()
    finally:
        tsvc.close()
    assert jstats["preempted"] > 0 and tstats["preempted"] > 0
    compared = replayed = 0
    for prompt, jg, tg in zip(prompts, jgens, tgens):
        assert len(tg.tokens) == len(jg.tokens) == max_new
        for k, t in enumerate(tg.tokens):
            assert abs(tg.entropy[k] - jg.entropy[k]) < 1e-4
            assert abs(tg.mutual_info[k] - jg.mutual_info[k]) < 1e-4
            compared += 1
            if t != jg.tokens[k]:
                # a near-tie: the reference's margin is within 1e-5
                assert _jax_margin(stacked, jcfg,
                                   prompt + jg.tokens[:k]) <= 1e-5
                break
            assert abs(tg.logprobs[k] - jg.logprobs[k]) < 1e-4
        replayed += tg.preemptions > 0 and k == max_new - 1
    assert compared >= 2 * max_new + 1
    assert replayed >= 1     # a replayed row was held to its very end


def test_page_pool_matches_jax():
    ops = [("alloc", 0, 2), ("alloc", 1, 3), ("alloc", 2, 4), ("alloc", 0, 1),
           ("release", 1, 0), ("alloc", 2, 2), ("alloc", 3, 5),
           ("release", 0, 0), ("alloc", 3, 1), ("release", 9, 0)]
    jp, tp = JPagePool(8, 4, max_seq_pages=5), PagePool(8, 4, max_seq_pages=5)
    for op, sid, n in ops:
        if op == "alloc":
            assert tp.alloc(sid, n) == jp.alloc(sid, n)
        else:
            assert tp.release(sid) == jp.release(sid)
        assert tp.free_pages == jp.free_pages
        for s in range(4):
            assert tp.pages_of(s) == jp.pages_of(s)
            a, b = np.full(5, -1, np.int32), np.full(5, -1, np.int32)
            tp.fill_block_row(s, a)
            jp.fill_block_row(s, b)
            assert a.tolist() == b.tolist()
    assert tp.snapshot_stats() == jp.snapshot_stats()


def test_predictive_heads_match_jax_with_capacity_mask():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 3, 11)).astype(np.float32) * 3
    logits[2] = np.nan                        # a dead padding slot
    mask = np.array([1, 1, 0, 1], np.float32)
    want = junc.predictive_heads(jnp.asarray(logits), "classify",
                                 jnp.asarray(mask))
    got = tunc.predictive_heads(torch.from_numpy(logits), "classify",
                                torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() < 1e-5, k


@pytest.mark.parametrize("m", [1, 3, 4, 5, 17])
def test_bucketing_matches_jax(m):
    assert tbucketing.bucket_size(m) == jbucketing.bucket_size(m)
    x = np.arange(m * 2, dtype=np.float32).reshape(m, 2)
    target = jbucketing.bucket_size(m)
    want = jbucketing.pad_rows({"x": jnp.asarray(x)}, target)["x"]
    got = tbucketing.pad_rows({"x": torch.from_numpy(x)}, target)["x"]
    assert np.array_equal(got.numpy(), np.asarray(want))


def _port_modules():
    src = REPO / "src"
    return sorted(".".join(p.relative_to(src).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (src / "repro_torch").rglob("*.py"))


def test_import_leaves_jax_and_repro_out():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_port_file_imports_jax_or_repro():
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {name}"
