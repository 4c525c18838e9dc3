"""Speculative decode under clone/kill churn, a hypothesis sweep on the
CPU (the port's counterpart of
``tests/test_speculative.py::test_speculative_property_token_exact_under_churn``).

Three services over the same two tiny-qwen particles (initialized by the
reference, carried over as numpy): the port's plain scheduler, the port's
speculative scheduler, and the reference's plain scheduler. For random
prompts, lengths and budgets, with or without a clone/kill round trip on
both port services between requests (the clone also serves one request
while the ensemble is widened: the two PDs draw the same jitter from
their seeded generators, so their widened ensembles are equal), the port's
speculative tokens equal its plain tokens and the reference's plain
tokens exactly, logprobs within 1e-4.

Warmup covers every prompt bucket the sweep can draw (prompts of 1-15
tokens: buckets 1-16; the pool never runs dry, so no re-admission
prefills a longer replay), so any miss in either port cache after warmup
would be a capture caused by churn: there must be none. The reference's
own sweep warms only buckets 4, 8 and 16, and its cold-compile check then
fails on ``('paged_prefill', 16, ...)`` programs for prompts of 1 and 2
tokens (ROADMAP.md §3, open check 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import ParticleModule as JModule
from repro.core import PushDistribution as JPD
from repro.models import api as japi
from repro.serve import serve_decode as jserve_decode
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.serve import serve_decode
from test_torch_speculative import _cfgs, _jax_stacked, _to_port

BUCKETS = (1, 2, 4, 8, 16)


def test_speculative_property_token_exact_under_churn():
    jcfg, tcfg = _cfgs()
    stacked = jax.tree.map(np.asarray, _jax_stacked(jcfg, 2))
    rows = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(2)]
    pds = []
    for _ in range(2):
        pd = PushDistribution(ParticleModule(init=None, cfg=tcfg),
                              capacity=4, device="cpu")
        for r in rows:
            pd.p_create(params=_to_port(r))
        pds.append(pd)
    jmod = JModule(init=lambda r: japi.init_params(r, jcfg),
                   loss=lambda p, b: japi.loss_fn(p, b, jcfg),
                   forward=lambda p, b: japi.forward(p, b, jcfg)[0],
                   cfg=jcfg)
    jpd = JPD(jmod, num_devices=1, seed=0)
    for r in rows:
        jpd.p_create(params=jax.tree.map(jnp.asarray, r))
    kw = dict(num_pages=32, page_size=8, max_active=2)
    svcs = [serve_decode(pds[0], tcfg, warmup_buckets=BUCKETS, **kw),
            serve_decode(pds[1], tcfg, warmup_buckets=BUCKETS,
                         speculative=True, **kw)]
    jsvc = jserve_decode(jpd, jcfg, decode_kernel=False, warmup=False, **kw)
    misses = [s.stats()["misses"] for s in svcs]
    gens = [pd.store.generation() for pd in pds]
    seen = {"churn": 0}

    @settings(deadline=None, max_examples=10, derandomize=True,
              database=None)
    @given(seed=st.integers(0, 2**16), plen=st.integers(1, 15),
           max_new=st.integers(1, 8), churn=st.booleans())
    def run(seed, plen, max_new, churn):
        rng = np.random.default_rng(seed)
        prompt = list(map(int, rng.integers(1, jcfg.vocab_size, plen)))
        if churn:
            seen["churn"] += 1
            twins = []
            for pd, svc in zip(pds, svcs):
                with svc.scheduler.step_lock:
                    twins.append(pd.p_clone(0, jitter=0.01))
            wide = [s.generate(prompt, max_new=max_new) for s in svcs]
            assert wide[0].tokens == wide[1].tokens
            for pd, svc, twin in zip(pds, svcs, twins):
                with svc.scheduler.step_lock:
                    pd.p_kill(twin)
        a, b = (s.generate(prompt, max_new=max_new) for s in svcs)
        r = jsvc.generate(prompt, max_new=max_new)
        assert a.tokens == b.tokens == r.tokens
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)
        np.testing.assert_allclose(a.logprobs, r.logprobs, atol=1e-4)

    try:
        run()
        assert seen["churn"] > 0
        for svc, m in zip(svcs, misses):
            st_ = svc.stats()
            assert st_["misses"] == m, "churn captured a step"
            assert st_["pool"]["used_pages"] == 0
        assert [pd.store.generation() for pd in pds] == gens
        assert svcs[1].stats()["speculative"]["spec_steps"] > 0
    finally:
        for s in svcs + [jsvc]:
            s.close()
        for pd in pds + [jpd]:
            pd.cleanup()
