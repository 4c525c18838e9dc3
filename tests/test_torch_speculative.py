"""The port's speculative BMA decode against the JAX package, on the CPU.

The reference initializes the weights (the 2-layer tiny qwen config of
``tests/test_speculative.py``) and they cross over as numpy through
``repro_torch.interop.params_from_numpy``. Checks:

  * ``api.decode_window_paged`` against the reference's (its Pallas window
    kernel in interpret mode) over P = 2: logits and pages within 1e-4;
  * one window pass against W sequential decode steps of the port: logits
    and pages within 1e-4, with the window length masking the tail;
  * the draft writes the draft particle's KV through a one-particle view
    into the pool itself, and leaves the other particles' pages alone;
  * ``serve_decode(speculative=True)`` against the REFERENCE'S PLAIN
    scheduler on the reference's prompts: identical tokens, logprob,
    entropy and mutual information within 1e-4, an eos stop inside the
    first window, the reference's stats key set and invariants, and the
    pool drained to 0 pages; under preemption, against the port's plain
    scheduler;
  * adaptive K at full acceptance, ``PagePool.release_tail`` against the
    reference's, and the speculative options that are not ported.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.serve import PagePool as JPagePool
from repro.serve import serve_decode as jserve_decode
from repro_torch import configs as tconfigs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.runtime import ProgramCache
from repro_torch.runtime.specs import spec_draft_step
from repro_torch.serve import PagePool, SpecConfig, serve_decode
from repro_torch.serve.speculative import resolve_spec_config

TINY = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=128)
P = 2


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


def _max_diff(a, b):
    want = dict(_paths(b))
    return max(float((leaf - want[path]).abs().max())
               for path, leaf in _paths(a))


def _prefilled(tcfg, tparams, prompt, ps=8, n_pmax=6, num_pages=16):
    """The port's pool after a paged prefill of ``prompt`` (row pages 2..)."""
    pages = tree_map(lambda a: torch.zeros((P,) + tuple(a.shape)),
                     tapi.paged_cache_init(tcfg, num_pages=num_pages,
                                           page_size=ps, device="cpu"))
    bt_row = torch.arange(2, 2 + n_pmax, dtype=torch.int32)
    padded = torch.zeros((1, 16), dtype=torch.int32)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    first, pages = tapi.prefill_paged(tparams, padded, pages, bt_row,
                                      len(prompt), tcfg)
    return first, pages, bt_row[None]


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def test_decode_window_paged_matches_jax():
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg)
    tparams = _to_port(stacked)
    L, W, ps = 13, 4, 8
    rng = np.random.default_rng(5)
    prompt = list(map(int, rng.integers(1, jcfg.vocab_size, L)))
    _, tpages, bt = _prefilled(tcfg, tparams, prompt)
    jpages = jax.tree.map(jnp.asarray, tree_map(lambda a: a.numpy(), tpages))
    win = np.asarray([[prompt[-1], 7, 19, 3], [0, 0, 0, 0]], np.int32)
    bt2 = np.concatenate([bt.numpy(), np.zeros_like(bt.numpy())])
    sl = np.asarray([L - 1, -1], np.int32)          # and an inactive row
    wl = np.asarray([W, 0], np.int32)
    jl, jpages = jax.vmap(lambda p, pg: japi.decode_window_paged(
        p, jnp.asarray(win), pg, jnp.asarray(bt2), jnp.asarray(sl),
        jnp.asarray(wl), jcfg))(stacked, jpages)
    tl, tpages = tapi.decode_window_paged(
        tparams, torch.from_numpy(win), tpages, torch.from_numpy(bt2),
        torch.from_numpy(sl), torch.from_numpy(wl), tcfg)
    assert tl.shape == (P, 2, W, jcfg.vocab_size)
    assert np.abs(np.asarray(jl)[:, 0] - tl.numpy()[:, 0]).max() < 1e-4
    want = dict(_paths(jax.tree.map(np.asarray, jpages)))
    for path, leaf in _paths(tpages):
        assert np.abs(leaf.numpy() - want[path]).max() < 1e-4, path


def test_window_matches_sequential_decode():
    """One window pass == W sequential single-token steps (logits and the
    pool they leave); the window length masks the tail."""
    jcfg, tcfg = _cfgs()
    tparams = _to_port(_jax_stacked(jcfg))
    L, W = 13, 4
    rng = np.random.default_rng(5)
    prompt = list(map(int, rng.integers(1, jcfg.vocab_size, L)))
    first, pages, bt = _prefilled(tcfg, tparams, prompt)
    seq_pages = tree_map(torch.clone, pages)
    toks, seq_logits = [int(first[0, 0].argmax())], []
    for step in range(W):
        lg, seq_pages = tapi.decode_step_paged(
            tparams, torch.tensor([toks[-1]], dtype=torch.int32), seq_pages,
            bt, torch.tensor([L + step], dtype=torch.int32), tcfg)
        seq_logits.append(lg)
        toks.append(int(lg[0, 0].argmax()))
    win = torch.tensor([toks[:W]], dtype=torch.int32)
    sl = torch.tensor([L], dtype=torch.int32)
    win_pages = tree_map(torch.clone, pages)
    wlog, win_pages = tapi.decode_window_paged(
        tparams, win, win_pages, bt, sl, torch.tensor([W], dtype=torch.int32),
        tcfg)
    for w in range(W):
        assert float((wlog[:, :, w] - seq_logits[w]).abs().max()) < 1e-4, w
    assert _max_diff(win_pages, seq_pages) < 1e-4
    # win_len = 2: positions past it are neither scored nor written
    short_pages = tree_map(torch.clone, pages)
    wlog2, short_pages = tapi.decode_window_paged(
        tparams, win, short_pages, bt, sl, torch.tensor([2], dtype=torch.int32),
        tcfg)
    for w in range(2):
        assert float((wlog2[:, :, w] - seq_logits[w]).abs().max()) < 1e-4
    k = short_pages["units"][0]["k"]
    page, slot = int(bt[0, (L + 2) // 8]), (L + 2) % 8
    assert float(k[:, :, page, slot].abs().max()) == 0.0


def test_draft_writes_through_the_particle_view():
    """The draft runs over ``a[slot:slot+1]`` views: its KV rows land in the
    pool itself, for the draft particle only."""
    jcfg, tcfg = _cfgs()
    tparams = _to_port(_jax_stacked(jcfg))
    L = 9
    prompt = list(range(3, 3 + L))
    _, pages, bt = _prefilled(tcfg, tparams, prompt)
    before = tree_map(torch.clone, pages)

    def decode_fn(params, pg, tokens, block_tables, seq_lens):
        return tapi.decode_step_paged(params, tokens, pg, block_tables,
                                      seq_lens, tcfg)

    packed = torch.cat([torch.tensor([[prompt[-1], L - 1, 3]],
                                     dtype=torch.int32), bt], 1)
    spec = spec_draft_step(decode_fn, slot=1, n_iter=3)
    drafts, pages = ProgramCache().run(spec, tparams, pages, packed)
    assert drafts.shape == (1, 3)
    k_new, k_old = pages["units"][0]["k"], before["units"][0]["k"]
    page, slots = int(bt[0, 1]), [(L - 1 + j) % 8 for j in range(3)]
    assert all(float((k_new[1, :, page, s] - k_old[1, :, page, s]).abs().max())
               > 0 for s in slots)
    assert torch.equal(k_new[0], k_old[0])          # the other particle
    # the drafts are the draft particle's own greedy tokens
    tok, row = prompt[-1], tree_map(lambda a: a[1:2], before)
    for j in range(3):
        lg, row = tapi.decode_step_paged(
            tree_map(lambda a: a[1:2], tparams),
            torch.tensor([tok], dtype=torch.int32), row, bt,
            torch.tensor([L - 1 + j], dtype=torch.int32), tcfg)
        tok = int(lg[0, 0].argmax())
        assert int(drafts[0, j]) == tok


# ---------------------------------------------------------------------------
# the speculative scheduler end to end
# ---------------------------------------------------------------------------

def _jax_plain(jcfg, prompts, max_new, **kw):
    """The reference's PLAIN scheduler over 2 particles: (stacked params,
    generations)."""
    module = JModule(init=lambda r: japi.init_params(r, jcfg),
                     loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                     forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                     cfg=jcfg)
    with JPD(module, num_devices=1, seed=0) as jpd:
        for _ in range(P):
            jpd.p_create()
        stacked = jpd.store.stacked("params")
        svc = jserve_decode(jpd, jcfg, decode_kernel=False, warmup=False,
                            **kw)
        try:
            gens = [h.result(300) for h in
                    [svc.generate_async(p, max_new=max_new) for p in prompts]]
        finally:
            svc.close()
    return stacked, gens


def _port_pd(tcfg, stacked):
    tparams = _to_port(stacked)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    for p in range(P):
        pd.p_create(params=tree_map(lambda a: a[p], tparams))
    return pd


def test_speculative_matches_reference_plain_scheduler():
    """Same prompts, same particles: the port's speculative scheduler
    reproduces the reference's plain scheduler's tokens and heads, across
    mixed prompt lengths, admission churn (more prompts than rows) and an
    eos stop inside the first window; its stats account for every drafted
    and accepted token."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size,
                                          int(rng.integers(3, 15)))))
               for _ in range(5)]
    stacked, plain = _jax_plain(jcfg, prompts, 6, num_pages=32, page_size=8,
                                max_active=3)
    svc = serve_decode(_port_pd(tcfg, stacked), tcfg, num_pages=32,
                       page_size=8, max_active=3, speculative=True)
    try:
        spec = [h.result(300) for h in
                [svc.generate_async(p, max_new=6) for p in prompts]]
        # eos equal to the first generated token: stops inside the first
        # accepted window, the emitted tokens cut at eos
        g = svc.generate(prompts[0], max_new=6, eos_id=plain[0].tokens[0])
        assert g.tokens == plain[0].tokens[:1]
        assert g.finish_reason == "eos"
        st = svc.stats()
    finally:
        svc.close()
    for a, b in zip(plain, spec):
        assert a.tokens == b.tokens
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)
        np.testing.assert_allclose(a.entropy, b.entropy, atol=1e-4)
        np.testing.assert_allclose(a.mutual_info, b.mutual_info, atol=1e-4)
    ss = st["speculative"]
    assert set(ss) == {"spec_steps", "draft_calls", "verify_calls",
                       "drafted_tokens", "accepted_tokens",
                       "rollback_pages", "acceptance_rate",
                       "tokens_per_step", "k_max", "adaptive",
                       "quantized", "mean_k"}
    assert ss["verify_calls"] == ss["spec_steps"] == st["steps"]
    assert ss["draft_calls"] <= ss["spec_steps"]
    assert 0.0 <= ss["acceptance_rate"] <= 1.0
    assert ss["accepted_tokens"] <= ss["drafted_tokens"]
    assert st["generated_tokens"] >= st["steps"]
    assert st["h2d_transfers"] == (ss["draft_calls"] + ss["verify_calls"]
                                   + st["prefills"])
    assert st["pool"]["used_pages"] == 0


def test_speculative_under_preemption_matches_plain():
    """A pool too small for the load preempts and replays rows; the
    speculative scheduler still emits the port's plain tokens and drains
    the pool."""
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg)
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, 12)))
               for _ in range(3)]
    outs, stats = [], []
    for spec in (None, SpecConfig(k_max=3)):
        svc = serve_decode(_port_pd(tcfg, stacked), tcfg, num_pages=9,
                           page_size=4, max_active=3, speculative=spec,
                           warmup=False)
        try:
            outs.append([h.result(300) for h in
                         [svc.generate_async(p, max_new=8) for p in prompts]])
            stats.append(svc.stats())
        finally:
            svc.close()
    assert stats[1]["preempted"] > 0
    assert stats[1]["pool"]["used_pages"] == 0
    for a, b in zip(*outs):
        assert a.tokens == b.tokens
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)


def test_adaptive_k_tracks_acceptance():
    """A one-particle 'ensemble' accepts every draft: K stays at k_max and
    the scheduler emits full windows (7 tokens: 1 + 3 + 3, 3 steps)."""
    jcfg, tcfg = _cfgs()
    stacked = _jax_stacked(jcfg, 1)
    pd = PushDistribution(ParticleModule(init=None, cfg=tcfg), device="cpu")
    pd.p_create(params=tree_map(lambda a: a[0], _to_port(stacked)))
    svc = serve_decode(pd, tcfg, num_pages=32, page_size=8, max_active=2,
                       warmup=False, speculative=SpecConfig(k_max=3))
    try:
        g = svc.generate([5, 9, 23, 41], max_new=7)
        assert len(g.tokens) == 7
        ss = svc.stats()["speculative"]
        assert ss["acceptance_rate"] == 1.0
        assert ss["rollback_pages"] == 0
        assert ss["spec_steps"] <= 3
    finally:
        svc.close()


def test_resolve_spec_config_and_unported_options():
    assert resolve_spec_config(None) is None
    assert resolve_spec_config(False) is None
    assert resolve_spec_config(True).k_max == 4
    assert resolve_spec_config(7).k_max == 7
    cfg = SpecConfig(k_max=2, adaptive=False)
    assert resolve_spec_config(cfg) is cfg
    with pytest.raises(TypeError):
        resolve_spec_config("yes")
    with pytest.raises(ValueError):
        SpecConfig(k_max=0)
    with pytest.raises(ValueError):
        SpecConfig(ema_alpha=0.0)
    # the int8 draft is ported (tests/test_torch_precision.py runs it)
    assert resolve_spec_config(SpecConfig(quantized=True)).quantized


RELEASE_OPS = [
    [("alloc", 0, 3), ("tail", 0, 5), ("tail", 0, 5), ("tail", 0, 0)],
    [("alloc", 0, 2), ("alloc", 1, 4), ("tail", 1, 9), ("alloc", 0, 2),
     ("tail", 0, 13), ("release", 1, 0), ("tail", 0, 4)],
    [("alloc", 2, 5), ("tail", 2, 20), ("tail", 2, 17), ("tail", 2, 1)],
]


@pytest.mark.parametrize("ops", RELEASE_OPS)
def test_release_tail_matches_jax(ops):
    jp, tp = JPagePool(8, 4, max_seq_pages=5), PagePool(8, 4, max_seq_pages=5)
    for op, sid, n in ops:
        if op == "alloc":
            assert tp.alloc(sid, n) == jp.alloc(sid, n)
        elif op == "tail":
            assert tp.release_tail(sid, n) == jp.release_tail(sid, n)
        else:
            assert tp.release(sid) == jp.release(sid)
        assert tp.free_pages == jp.free_pages
        assert list(tp._free) == list(jp._free)
        for s in range(3):
            assert tp.pages_of(s) == jp.pages_of(s)
    assert tp.snapshot_stats() == jp.snapshot_stats()


def test_release_tail_errors():
    pool = PagePool(8, 4, max_seq_pages=5)
    with pytest.raises(KeyError):
        pool.release_tail(3, 1)                  # never owned
    pool.alloc(0, 2)
    with pytest.raises(ValueError):
        pool.release_tail(0, -1)
    pool.release(0)
    with pytest.raises(KeyError):
        pool.release_tail(0, 0)                  # a double release
