"""The port's ProgramCache (``repro_torch.runtime``) against the
reference's, on the CPU.

The cache-key tests of ``tests/test_runtime.py`` run on the port with a
stub capturer that counts captures; after every lookup the port's
``snapshot_stats()`` must equal the reference ``ProgramCache``'s after
the same sequence (hit/miss/cold stats, shapes and specs distinguished,
bucketed shapes sharing, the state token, LRU eviction). On top of the
reference's key: an in-place ("state"/"rows") argument is keyed on its
leaves' addresses, so a replaced tensor misses while an in-place update
hits, and copied ("replicated") arguments are keyed on shape alone.
Serving dispatches through the cache: warmup captures every step a
scheduler runs, and admission, retirement and preemption after it
capture nothing; a params commit misses. A program goes with the
tensors it was captured on: a cache drops it once one of them is freed,
and a service's own cache is emptied when the service closes.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's runtime imports via core)
from repro.runtime import ProgramCache as JCache
from repro.runtime import ProgramSpec as JSpec
from repro.runtime import bucket_size as jbucket_size
from repro.runtime import ident as jident
from repro.runtime import pad_rows as jpad_rows
from repro_torch import configs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_map
from repro_torch.models import api
from repro_torch.runtime import (CompiledRuntime, ProgramCache, ProgramSpec,
                                 abstract_key, arg_key, bucket_size, eager,
                                 global_cache, ident, pad_rows)
from repro_torch.runtime.program import Program
from repro_torch.serve import serve_decode


class Stub:
    """A capturer that counts its captures and runs the body eagerly."""

    def __init__(self):
        self.captured = []

    def __call__(self, spec, args, cache_key=None):
        self.captured.append(spec.name)
        return eager(spec, args, cache_key)


def _double(tag="double"):
    j = JSpec(name=tag, key=(tag,),
              make=lambda ctx: lambda s, b: (s, b * 2.0),
              in_kinds=("state", "replicated"))
    t = ProgramSpec(name=tag, key=(tag,),
                    make=lambda ctx: lambda s, b: (s, b * 2.0),
                    in_kinds=("state", "replicated"))
    return j, t


# each op: (spec tag, state shape, batch shape, state token)
SEQUENCES = {
    "hit_miss_cold": [("double", (2, 3), (4,), None)] * 2,
    "shapes_and_specs": [("double", (2, 3), (4,), None),
                         ("double", (2, 3), (8,), None),
                         ("other", (2, 3), (4,), None)],
    "bucketed_shapes": [("double", (2, 3), (bucket_size(m), 5), None)
                        for m in (3, 4, 2, 4)],
    "state_token": [("double", (2, 3), (4,), 1), ("double", (2, 3), (4,), 1),
                    ("double", (2, 3), (4,), 2)],
    "lru_eviction": [("double", (2, 3), (m,), None) for m in (1, 2, 3, 1)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_stats_match_reference_cache(name):
    max_programs = 2 if name == "lru_eviction" else 512
    jcache = JCache(max_programs=max_programs)
    stub = Stub()
    tcache = ProgramCache(max_programs=max_programs, capturer=stub)
    specs = {tag: _double(tag) for tag in ("double", "other")}
    st_t = {}
    for tag, sshape, bshape, token in SEQUENCES[name]:
        jspec, tspec = specs[tag]
        # one state tensor per shape, as a store holds it across steps
        st = st_t.setdefault(sshape, torch.ones(sshape))
        jout = jcache.run(jspec, jnp.ones(sshape), jnp.ones(bshape),
                          state_token=token)
        tout = tcache.run(tspec, st, torch.ones(bshape), state_token=token)
        assert np.array_equal(np.asarray(jout[1]), tout[1].numpy())
        assert tcache.snapshot_stats() == jcache.snapshot_stats()
    s = tcache.snapshot_stats()
    assert len(stub.captured) == s["cold_compiles"] == s["misses"]
    assert len(tcache) == s["programs"]


def test_bucketing_pads_like_reference():
    for m in (3, 4, 2, 5):
        want = jpad_rows(jnp.arange(m * 5.0).reshape(m, 5), jbucket_size(m))
        got = pad_rows(torch.arange(m * 5.0).reshape(m, 5), bucket_size(m))
        assert np.array_equal(np.asarray(want), got.numpy())


def test_ident_is_stable_and_distinct():
    f, g = (lambda x: x), (lambda x: x)
    assert ident(f) == ident(f)
    assert ident(f) != ident(g)
    assert (jident(f) == jident(f)) and (jident(f) != jident(g))


def test_in_place_arguments_key_on_addresses():
    """A "state" argument with a new data_ptr misses; an in-place update of
    the same tensor hits; copied arguments key on shape and dtype only."""
    stub = Stub()
    cache = ProgramCache(capturer=stub)
    _, spec = _double()
    st = torch.zeros(2, 3)
    cache.run(spec, st, torch.ones(4))
    st.add_(1.0)                                   # in place: same address
    cache.run(spec, st, torch.full((4,), 7.0))     # new values, same shape
    assert cache.snapshot_stats()["hits"] == 1
    cache.run(spec, st.clone(), torch.ones(4))     # same shape, new address
    cache.run(spec, st[:, :2], torch.ones(4))      # a view: new shape
    cache.run(spec, st, torch.ones(4, dtype=torch.float64))
    s = cache.snapshot_stats()
    assert s["misses"] == s["cold_compiles"] == 4 and s["hits"] == 1
    assert arg_key("state", st) != arg_key("state", st.clone())
    assert arg_key("replicated", st) == arg_key("replicated", st.clone())
    assert arg_key("replicated", st) == abstract_key(st)
    # numpy and Python scalars key by shape and dtype name too
    assert abstract_key(np.zeros((2, 3), np.int32)) == \
        abstract_key(torch.zeros((2, 3), dtype=torch.int32))
    assert abstract_key({"pos": 3}) == abstract_key({"pos": 9}) != \
        abstract_key({"pos": 3.0})


def test_default_capturer_runs_the_cpu_eagerly():
    cache = ProgramCache()
    _, spec = _double()
    # the state lives on: the cache drops a program once its in-place
    # tensors are freed
    st = torch.ones(2, 3)
    prog, hit = cache.lookup(spec, (st, np.ones(4, np.float32)))
    assert not hit and isinstance(prog, Program) and prog.graph is None
    _, out = prog(st, np.full(4, 3.0, np.float32))
    assert out.tolist() == [6.0] * 4
    assert cache.program_costs()[0]["graph"] is False


def test_bad_kinds_rejected():
    with pytest.raises(ValueError):
        ProgramSpec(name="x", key=("x",), make=lambda ctx: None,
                    in_kinds=("bogus",))
    with pytest.raises(ValueError):
        ProgramSpec(name="x", key=("x",), make=lambda ctx: None,
                    in_kinds=("state",), out_kinds=("bogus",))
    with pytest.raises(ValueError, match="arguments"):
        ProgramCache().run(_double()[1], torch.ones(2))


def test_lru_keeps_evicted_programs_working():
    cache = ProgramCache(max_programs=1, capturer=Stub())
    _, spec = _double()
    st = torch.ones(2, 3)
    first = cache.program(spec, (st, torch.ones(1)))
    cache.run(spec, st, torch.ones(2))
    assert cache.snapshot_stats()["evictions"] == 1
    assert first(st, torch.ones(1))[1].tolist() == [2.0]
    cache.clear()
    assert len(cache) == 0


def test_a_freed_in_place_tensor_releases_its_program():
    cache = ProgramCache(capturer=Stub())
    _, spec = _double()
    keep, gone = torch.ones(2, 3), torch.ones(2, 3)
    cache.run(spec, keep, torch.ones(4))
    cache.run(spec, gone, torch.ones(4))
    assert len(cache) == 2 and cache.released == 0
    del gone
    gc.collect()
    assert len(cache) == 1 and cache.released == 1
    s = cache.snapshot_stats()
    assert s["programs"] == 1 and s["evictions"] == 0
    cache.run(spec, keep, torch.ones(4))
    assert cache.snapshot_stats()["hits"] == 1


# ---------------------------------------------------------------------------
# the runtime and the serving engines
# ---------------------------------------------------------------------------

TINY = dict(n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=128, max_seq_len=128)


def _pd(n=2):
    cfg = configs.get("qwen1.5-0.5b").replace(**TINY)
    pd = PushDistribution(ParticleModule(
        init=lambda g: api.init_params(g, cfg), cfg=cfg), device="cpu")
    for _ in range(n):
        pd.p_create()
    return pd, cfg


def test_compiled_runtime_runs_under_the_store_generation():
    pd, _ = _pd()
    rt = CompiledRuntime(pd, ProgramCache(capturer=Stub()))
    _, spec = _double()
    st = torch.ones(2, 3)
    rt.run(spec, st, torch.ones(4))
    rt.run(spec, st, torch.ones(4))
    pd.p_create()                       # a third particle: capacity grows
    rt.run(spec, st, torch.ones(4))
    s = rt.stats()["program_cache"]
    assert s["hits"] == 1 and s["cold_compiles"] == 2
    assert rt.stats()["backend"] == "compiled"
    assert global_cache() is CompiledRuntime(pd).cache


@pytest.mark.parametrize("speculative", [None, 2])
def test_no_capture_after_warmup_under_churn(speculative):
    """Warmup captures every step the scheduler runs (the decode step, or
    the draft at each slot of the store's capacity and each iteration
    count, and the verify; each warmed prefill bucket). Then requests that
    admit, retire and preempt (a pool of 12 pages for three rows growing
    to 5-6 pages each) capture nothing."""
    pd, cfg = _pd()
    stub = Stub()
    cache = ProgramCache(capturer=stub)
    svc = serve_decode(pd, cfg, num_pages=12, page_size=4, max_active=3,
                       warmup_buckets=(4, 8, 16, 32), speculative=speculative,
                       cache=cache)
    try:
        warm = sorted(stub.captured)
        want = (["paged_prefill"] * 4
                + (["paged_decode_step"] if speculative is None
                   else ["spec_draft_step"] * 2 * pd.store.capacity
                   + ["spec_verify"]))
        assert warm == sorted(want)
        rng = np.random.default_rng(1)
        handles = [svc.generate_async(list(rng.integers(1, 100, n)),
                                      max_new=8) for n in (9, 13, 11, 12, 7)]
        gens = [h.result(300) for h in handles]
        st = svc.stats()
    finally:
        svc.close()
    assert all(len(g.tokens) == 8 for g in gens)
    assert st["preempted"] >= 1 and st["retired"] == 5
    assert sorted(stub.captured) == warm            # nothing more
    assert st["cold_compiles"] == len(warm) and st["misses"] == len(warm)
    assert st["hits"] == st["engine"]["bucket_hits"] > 0


def test_params_commit_misses():
    """A training commit replaces the stacked params: the next decode step
    must miss (a graph is never replayed on the old tensors); a commit of
    the same tree object keeps its program."""
    pd, cfg = _pd()
    stub = Stub()
    svc = serve_decode(pd, cfg, num_pages=8, page_size=4, max_active=2,
                       cache=ProgramCache(capturer=stub))
    try:
        assert stub.captured == ["paged_decode_step"]
        svc.scheduler.warmup()
        assert stub.captured == ["paged_decode_step"]
        store = pd.store
        store.commit("params", tree_map(torch.clone,
                                        store.stacked("params")))
        svc.scheduler.warmup()
        assert stub.captured == ["paged_decode_step"] * 2
        store.commit("params", store.stacked("params"))
        svc.scheduler.warmup()
        assert stub.captured == ["paged_decode_step"] * 2
    finally:
        svc.close()


def test_programs_go_with_their_service():
    """A service's own cache is emptied by close(); with a shared cache,
    the next service's pool replaces the old one and its programs go."""
    pd, cfg = _pd()
    svc = serve_decode(pd, cfg, num_pages=8, page_size=4, max_active=2)
    own = svc.engine.cache
    assert own is not global_cache() and len(own) == 1
    svc.close()
    assert len(own) == 0
    cache = ProgramCache(capturer=Stub())
    for _ in range(2):
        svc = serve_decode(pd, cfg, num_pages=8, page_size=4, max_active=2,
                           cache=cache)
        svc.close()
    gc.collect()
    st = cache.snapshot_stats()
    assert st["cold_compiles"] == 2 and st["programs"] == 1
    assert cache.released == 1
