"""What step capture asks of the serving bodies, on the CPU.

  * every serving step body (paged decode, prefill, the draft at each
    iteration count, the verify window, the dense-cache step) runs under
    a dispatch mode that raises on ``aten.nonzero``,
    ``aten._local_scalar_dense`` and ``aten.is_nonzero``: no host sync,
    so the step has fixed shapes and can be captured as a CUDA graph;
  * the KV writes the reference drops (``mode="drop"``: inactive rows,
    window positions past a row's window, prompt padding) go to the
    pool's scratch page and leave it as it was: after a write of the same
    K/V values the whole pool equals the reference's scatter bit for bit;
  * ``prefill_paged`` with ``n_tokens`` a device scalar matches the
    reference at 1, Sp - 1 and Sp real tokens (logits 1e-4, pages 1e-5,
    the scratch page and untouched pages exact);
  * dense-cache decode with ``cur_pos`` a 0-d tensor matches the
    reference (1e-4) and the int form bit for bit; the position check
    reaches a captured step (``runtime.program.host_check``): a position
    outside the cache raises before the warm-up writes anything, and a
    program runs the check on each call's int before its replay, which
    returns fresh outputs;
  * ``paged_cache_init`` reserves the scratch page past the pages a block
    table may name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models.blocks import (paged_write_index, prefill_write_index,
                                       window_write_index, write_kv)
from repro_torch.runtime import eager, program
from repro_torch.runtime.specs import (bma_step, paged_decode_step,
                                       paged_prefill, spec_draft_step,
                                       spec_verify)
from repro_torch.serve import uncertainty
from repro_torch.serve.engine import sample_heads

TINY = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=128)
P, PS, NP, N_PMAX = 2, 8, 16, 6


def _cfgs():
    return (jconfigs.get("qwen1.5-0.5b").replace(**TINY),
            tconfigs.get("qwen1.5-0.5b").replace(**TINY))


def _jax_stacked(jcfg, n=P):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return jax.vmap(lambda k: japi.init_params(k, jcfg))(keys)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def _pool(tcfg, seed=3):
    """A port pool of NP pages and its scratch page (page NP) full of
    seeded noise, so that a page left alone is seen to be left alone."""
    shapes = tapi.paged_cache_init(tcfg, num_pages=NP, page_size=PS,
                                   device="meta")
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: torch.from_numpy(rng.standard_normal(
        (P,) + tuple(s.shape)).astype(np.float32)), shapes)


# ---------------------------------------------------------------------------
# no host sync in any serving step body
# ---------------------------------------------------------------------------

SYNCS = (torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
         torch.ops.aten.is_nonzero)


class NoHostSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in SYNCS:
            raise AssertionError(f"host sync in a step body: {func}")
        return func(*args, **(kwargs or {}))


def _step_cases(tcfg, tparams, pages, paged=True):
    def decode_fn(params, pg, tokens, bt, sl):
        return tapi.decode_step_paged(params, tokens, pg, bt, sl, tcfg)

    def prefill_fn(params, pg, tokens, bt_row, n):
        return tapi.prefill_paged(params, tokens, pg, bt_row, n, tcfg)

    def verify_fn(params, pg, tokens, bt, sl, wl):
        return tapi.decode_window_paged(params, tokens, pg, bt, sl, wl, tcfg)

    mask = torch.tensor([1.0, 0.0])
    bt = np.zeros((3, N_PMAX), np.int32)
    bt[0, :3], bt[2, :2] = [2, 3, 4], [9, 10]
    decode = np.concatenate([np.array([[5, 13], [0, -1], [7, 9]], np.int32),
                             bt], 1)
    prefill = np.zeros(16 + N_PMAX + 1, np.int32)
    prefill[:11] = np.arange(1, 12)
    prefill[16:16 + N_PMAX] = np.arange(2, 2 + N_PMAX)
    prefill[-1] = 11
    draft = np.concatenate([np.array([[5, 13, 3], [0, -1, 0], [7, 9, 1]],
                                     np.int32), bt], 1)
    verify = np.concatenate([np.array([[5, 6, 7, 8, 13, 4],
                                       [0, 0, 0, 0, -1, 0],
                                       [7, 1, 0, 0, 9, 2]], np.int32), bt], 1)
    if paged:
        yield paged_decode_step(decode_fn, sample_heads), (tparams, pages,
                                                           decode, mask)
        yield paged_prefill(prefill_fn, sample_heads, n_pmax=N_PMAX), (
            tparams, pages, prefill, mask)
        for n_iter in (1, 3):
            yield spec_draft_step(decode_fn, slot=1, n_iter=n_iter), (
                tparams, pages, draft)
        yield spec_verify(verify_fn, sample_heads, w_max=4), (tparams,
                                                              pages, verify,
                                                              mask)
    toks = torch.ones((3, 4), dtype=torch.int32)
    caches = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_len=6)[1]

    def forward(params, caches, batch):
        return tapi.decode_step(params, batch["token"], caches,
                                batch["cur_pos"], tcfg)

    reduce = lambda outs, m: uncertainty.predictive_heads(outs, "classify", m)
    for cur_pos in (torch.tensor(4), 5):
        yield bma_step(forward, reduce), (
            tparams, caches, {"token": toks[:, 0], "cur_pos": cur_pos}, mask)


def test_serving_step_bodies_never_sync_the_host():
    jcfg, tcfg = _cfgs()
    tparams = _to_port(_jax_stacked(jcfg))
    names = []
    for spec, args in _step_cases(tcfg, tparams, _pool(tcfg)):
        prog = eager(spec, args)
        with NoHostSync():
            prog(*args)
        names.append(spec.name)
    assert names == ["paged_decode_step", "paged_prefill", "spec_draft_step",
                     "spec_draft_step", "spec_verify", "bma_step", "bma_step"]
    # the dispatch mode does see a sync when there is one
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            torch.nonzero(torch.ones(3))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                                  "gemma3-4b"])
def test_zoo_step_bodies_never_sync_the_host(arch):
    """The same step bodies over the zoo's stacks: MoE layers (routing,
    capacity, the dispatch into fixed slots and the combine) and, for
    gemma3 (``local`` layers have no paged form), the dense-cache step
    over its ring caches; every shape fixed on the device."""
    tcfg = tconfigs.get(arch).smoke().replace(n_units=1, vocab_size=128)
    tparams = tree_map(lambda a: a[None].repeat(P, *([1] * a.dim())),
                       tapi.init_params(torch.Generator().manual_seed(0),
                                        tcfg))
    if arch == "gemma3-4b":
        cases = [c for c in _step_cases(tcfg, tparams, None, paged=False)]
    else:
        cases = list(_step_cases(tcfg, tparams, _pool(tcfg)))
    names = []
    for spec, args in cases:
        prog = eager(spec, args)
        with NoHostSync():
            prog(*args)
        names.append(spec.name)
    want = ["bma_step", "bma_step"]
    assert names == (want if arch == "gemma3-4b" else
                     ["paged_decode_step", "paged_prefill", "spec_draft_step",
                      "spec_draft_step", "spec_verify"] + want)


# ---------------------------------------------------------------------------
# the scratch page takes every dropped write
# ---------------------------------------------------------------------------

def _drop_scatter(pool, k, page_idx, slot):
    """The reference's dropping scatter (src/repro/models/blocks.py,
    ``.at[page_idx, slot].set(..., mode="drop")``), over the particle
    axis."""
    return jax.vmap(lambda pg, kk: pg.at[page_idx, slot].set(
        kk, mode="drop"))(jnp.asarray(pool), jnp.asarray(k))


@pytest.mark.parametrize("case", ["decode", "window", "prefill"])
def test_scratch_page_takes_every_dropped_write(case):
    """The same K/V values written by the port's index + ``write_kv`` and by
    the reference's index + dropping scatter (index formulas of
    ``attn_apply_paged``, ``attn_apply_window_paged`` and
    ``attn_apply_prefill_paged``): the pools agree bit for bit, scratch
    page included, and every dropped write is sent to the scratch page."""
    rng = np.random.default_rng(7)
    NPg, ps, KVH, hd, n_pmax = 10, 4, 2, 3, 3
    scratch = NPg - 1
    pool = rng.standard_normal((P, NPg, ps, KVH, hd)).astype(np.float32)
    bt = np.array([[0, 4, 2], [1, 3, 5], [6, 7, 8], [0, 0, 0]], np.int32)
    sl = np.array([5, -1, 9, -1], np.int32)
    if case == "decode":
        active = sl >= 0
        pos = np.where(active, sl, 0)
        page_idx = np.where(active, bt[np.arange(4), pos // ps], NPg)
        slot = pos % ps
        got = paged_write_index(torch.from_numpy(bt), torch.from_numpy(sl),
                                ps, scratch)
        shape = (P, 4, KVH, hd)
    elif case == "window":
        W = 3
        wl = np.array([2, 3, 1, 0], np.int32)
        valid = (sl >= 0)[:, None] & (np.arange(W)[None] < wl[:, None])
        pos = np.where(valid, sl[:, None] + np.arange(W), 0)
        page_idx = np.where(valid, np.take_along_axis(bt, pos // ps, 1), NPg)
        slot = pos % ps
        got = window_write_index(torch.from_numpy(bt), torch.from_numpy(sl),
                                 torch.from_numpy(wl), W, ps, scratch)
        shape = (P, 4, W, KVH, hd)
    else:
        Sp, n = 16, torch.tensor(7, dtype=torch.int32)     # 16 > 3 pages
        positions = np.arange(Sp)
        valid = positions < 7
        page_idx = np.where(valid, np.take(bt[1], positions // ps,
                                           mode="clip"), NPg)
        slot = positions % ps
        got = prefill_write_index(torch.from_numpy(bt[1]), n, Sp, ps, scratch)
        shape = (P, Sp, KVH, hd)
    new = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(_drop_scatter(pool, new, page_idx, slot))
    valid_t, page_t, _ = got
    assert np.array_equal(valid_t.numpy(), page_idx < NPg)
    assert (page_t.numpy()[~valid_t.numpy()] == scratch).all()
    pages = {"k": torch.from_numpy(pool.copy()),
             "v": torch.from_numpy(pool.copy())}
    write_kv(pages, torch.from_numpy(new), torch.from_numpy(new), got)
    for leaf in (pages["k"], pages["v"]):
        assert np.array_equal(leaf.numpy(), want)
    assert np.array_equal(pages["k"].numpy()[:, scratch], pool[:, scratch])


def test_decode_and_window_leave_the_scratch_page_alone():
    """A decode step and a verify window with inactive rows and short
    windows through the model: the scratch page is exactly as it was, and
    the real pages match the reference within the parity tolerance."""
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg)
    tparams = _to_port(stacked)
    tpages = _pool(tcfg)
    jpages = jax.tree.map(jnp.asarray, tree_map(lambda a: a.numpy(), tpages))
    before = tree_map(torch.clone, tpages)
    bt = np.array([[2, 3, 4, 0, 0, 0], [0] * 6, [9, 10, 0, 0, 0, 0]],
                  np.int32)
    sl = np.array([13, -1, 9], np.int32)
    tok = np.array([5, 0, 7], np.int32)
    jl, jpages = jax.vmap(lambda p, pg: japi.decode_step_paged(
        p, jnp.asarray(tok), pg, jnp.asarray(bt), jnp.asarray(sl), jcfg,
        decode_kernel=False))(stacked, jpages)
    tl, tpages = tapi.decode_step_paged(
        tparams, torch.from_numpy(tok), tpages, torch.from_numpy(bt),
        torch.from_numpy(sl), tcfg)
    assert np.abs(np.asarray(jl)[:, [0, 2]] - tl.numpy()[:, [0, 2]]).max() \
        < 1e-4
    win = np.array([[5, 6, 7, 8], [0] * 4, [7, 1, 2, 3]], np.int32)
    sl2, wl = np.array([14, -1, 10], np.int32), np.array([4, 0, 2], np.int32)
    jl, jpages = jax.vmap(lambda p, pg: japi.decode_window_paged(
        p, jnp.asarray(win), pg, jnp.asarray(bt), jnp.asarray(sl2),
        jnp.asarray(wl), jcfg))(stacked, jpages)
    tl, tpages = tapi.decode_window_paged(
        tparams, torch.from_numpy(win), tpages, torch.from_numpy(bt),
        torch.from_numpy(sl2), torch.from_numpy(wl), tcfg)
    assert np.abs(np.asarray(jl)[:, 0] - tl.numpy()[:, 0]).max() < 1e-4
    want = dict(_paths(jax.tree.map(np.asarray, jpages)))
    old = dict(_paths(before))
    scratch = tapi.scratch_page(tpages)
    assert scratch == NP
    for path, leaf in _paths(tpages):
        assert np.abs(leaf.numpy() - want[path]).max() < 1e-5, path
        assert torch.equal(leaf[..., scratch, :, :, :],
                           old[path][..., scratch, :, :, :]), path


# ---------------------------------------------------------------------------
# device scalars in place of host ints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 15, 16])
def test_prefill_with_device_n_tokens_matches_jax(n):
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg)
    tparams = _to_port(stacked)
    tpages = _pool(tcfg, seed=n)
    jpages = jax.tree.map(jnp.asarray, tree_map(lambda a: a.numpy(), tpages))
    before = tree_map(torch.clone, tpages)
    rng = np.random.default_rng(n)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :n] = rng.integers(1, jcfg.vocab_size, n)
    bt_row = np.array([2, 5, 3, 0, 0, 0], np.int32)
    jl, jpages = jax.vmap(lambda p, pg: japi.prefill_paged(
        p, jnp.asarray(prompt), pg, jnp.asarray(bt_row), jnp.int32(n),
        jcfg))(stacked, jpages)
    tl, tpages = tapi.prefill_paged(
        tparams, torch.from_numpy(prompt), tpages, torch.from_numpy(bt_row),
        torch.tensor(n, dtype=torch.int32), tcfg)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4
    want = dict(_paths(jax.tree.map(np.asarray, jpages)))
    old = dict(_paths(before))
    written = {2, 5}                      # 16 positions over pages of 8
    for path, leaf in _paths(tpages):
        assert np.abs(leaf.numpy() - want[path]).max() < 1e-5, path
        for page in set(range(NP + 1)) - written:   # the scratch page too
            assert torch.equal(leaf[..., page, :, :, :],
                               old[path][..., page, :, :, :]), (path, page)


def test_dense_decode_with_tensor_cur_pos_matches_jax():
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg)
    tparams = _to_port(stacked)
    L, steps = 9, 3
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, jcfg.vocab_size, (2, L)).astype(np.int32)
    jl, jc = jax.vmap(lambda p: japi.prefill(
        p, {"tokens": jnp.asarray(prompts)}, jcfg, max_len=L + steps))(
        stacked)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                          tcfg, max_len=L + steps)
    ic = tree_map(torch.clone, tc)
    for step in range(steps):
        tok = np.asarray(jl).mean(0).argmax(-1).astype(np.int32)
        jl, jc = jax.vmap(lambda p, c: japi.decode_step(
            p, jnp.asarray(tok), c, jnp.int32(L + step), jcfg,
            decode_kernel=True))(stacked, jc)
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(tok), tc,
                                  torch.tensor(L + step), tcfg)
        il, ic = tapi.decode_step(tparams, torch.from_numpy(tok), ic,
                                  L + step, tcfg)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4, step
        assert torch.equal(tl, il)
    for path, leaf in _paths(tc):
        assert torch.equal(leaf, dict(_paths(ic))[path]), path
    jk = np.asarray(jc["units"][0]["k"])
    assert np.abs(tc["units"][0]["k"].numpy() - jk).max() < 1e-4
    assert np.array_equal(tc["units"][0]["pos"].numpy(),
                          np.asarray(jc["units"][0]["pos"])[0])
    with pytest.raises(ValueError, match="outside"):
        tapi.decode_step(tparams, torch.from_numpy(tok), tc, L + steps, tcfg)


class _Replays:
    """A stand-in for a captured graph: counts its replays."""

    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_captured_dense_step_checks_cur_pos_on_the_host():
    jcfg, tcfg = _cfgs()
    tparams = _to_port(_jax_stacked(jcfg))
    toks = torch.ones((3, 4), dtype=torch.int32)
    caches = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_len=6)[1]
    mask = torch.tensor([1.0, 1.0])

    def forward(params, c, batch):
        return tapi.decode_step(params, batch["token"], c, batch["cur_pos"],
                                tcfg)

    spec = bma_step(forward, lambda o, m: uncertainty.predictive_heads(
        o, "classify", m))
    fn = spec.make(None)

    def warm_up(cur_pos):
        """A capture's warm-up on the CPU: the body over static copies."""
        args = (tparams, caches, {"token": toks[:, 0], "cur_pos": cur_pos},
                mask)
        static = tuple(a if k in program.IN_PLACE
                       else program._static_copy(a, torch.device("cpu"))
                       for k, a in zip(spec.in_kinds, args))
        with program._host_checks(spec.in_kinds, static, args) as checks:
            out = fn(*static)
        return static, out, checks

    before = tree_map(torch.clone, caches)
    with pytest.raises(ValueError, match="outside"):
        warm_up(6)
    for path, leaf in _paths(caches):       # nothing was written
        assert torch.equal(leaf, dict(_paths(before))[path]), path
    static, out, checks = warm_up(4)
    assert [(i, j) for i, j, _ in checks] == [(2, 1)]
    graph = _Replays()
    prog = program.Program(
        "bma_step", None, 2, graph=graph, in_kinds=spec.in_kinds,
        static_args=(None, None) + static[2:], static_out=(out[0], None),
        out_args=((1, 1),), checks=tuple(checks))
    batch = {"token": toks[:, 0], "cur_pos": 6}
    with pytest.raises(ValueError, match="outside"):
        prog(tparams, caches, batch, mask)
    with pytest.raises(ValueError, match="outside"):
        prog(tparams, caches, dict(batch, cur_pos=np.int32(-1)), mask)
    assert graph.n == 0
    heads, state = prog(tparams, caches, dict(batch, cur_pos=5), mask)
    assert graph.n == 1 and state is caches
    assert int(static[2]["cur_pos"]) == 5
    # the outputs are copies: a caller may keep them across replays
    for k, v in heads.items():
        assert v.data_ptr() != out[0][k].data_ptr()
        assert torch.equal(v, out[0][k]), k


def test_paged_cache_init_reserves_the_scratch_page():
    _, tcfg = _cfgs()
    pool = tapi.paged_cache_init(tcfg, num_pages=5, page_size=4,
                                 device="meta")
    for _, leaf in _paths(pool):
        assert leaf.shape[-4] == 6
    assert tapi.scratch_page(pool) == 5
