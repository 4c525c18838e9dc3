"""The port's runtime pieces on the CPU: the executor's FIFO, futures and
shutdown, ParticleStore lifecycle invariants, and the DecodeScheduler's
preemption, eos and request validation — the behaviours the reference
pins in tests/test_executor.py, tests/test_store.py and
tests/test_paged.py, held here against the port alone (it imports no
JAX)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import ParticleModule, ParticleStore, PushDistribution
from repro_torch.core.executor import Executor
from repro_torch.models import api
from repro_torch.serve import serve_decode


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _one_mailbox():
    """One device worker, no pool, one particle's mailbox (the decode
    scheduler's shape)."""
    ex = Executor(1, pool_size=0)
    ex.add_particle(0, 0)
    return ex


def test_executor_fifo_resolves_and_rejects():
    ex = _one_mailbox()
    log = []
    futs = [ex.submit(0, log.append, (i,)) for i in range(100)]

    def boom():
        raise ValueError("boom")

    bad = ex.submit(0, boom)
    assert ex.submit(0, lambda a, b=0: a + b, (40,), {"b": 2}).wait(10) == 42
    with pytest.raises(ValueError, match="boom"):
        bad.wait(10)
    assert all(f.done() for f in futs) and log == list(range(100))
    ex.shutdown()
    with pytest.raises(RuntimeError):
        ex.submit(0, lambda: None)


@pytest.mark.parametrize("drain", [True, False])
def test_executor_shutdown_finishes_or_rejects_queued_work(drain):
    """A call blocks the worker with work queued behind it: ``drain()``
    times out; ``shutdown`` then runs the queue (drain) or rejects it."""
    ex = _one_mailbox()
    release = threading.Event()
    first = ex.submit(0, release.wait, (10,))
    queued = [ex.submit(0, lambda i=i: i) for i in range(5)]
    with pytest.raises(TimeoutError):
        ex.drain(timeout=0.1)
    threading.Timer(0.2, release.set).start()
    ex.shutdown(drain=drain, timeout=10)
    assert first.wait(1) is True
    for i, f in enumerate(queued):
        if drain:
            assert f.wait(1) == i
        else:
            with pytest.raises(RuntimeError, match="shut down"):
                f.wait(1)


# ---------------------------------------------------------------------------
# ParticleStore
# ---------------------------------------------------------------------------

def _row(v):
    return {"w": torch.full((2, 3), float(v)), "b": (torch.tensor([v]),)}


def test_store_capacity_generation_and_mask():
    st = ParticleStore(capacity=3, device="cpu")
    assert st.capacity == 4
    for pid in range(3):
        st.register(pid)
    assert st.active_mask().tolist() == [0, 0, 0, 0]  # no data landed yet
    for pid in range(3):
        st.write("params", pid, _row(pid + 1))
    gen = st.generation()
    stacked = st.stacked("params")
    assert stacked["w"].shape == (4, 2, 3)
    assert stacked["w"][:, 0, 0].tolist() == [1, 2, 3, 0]  # free slot zero
    assert st.active_mask().tolist() == [1, 1, 1, 0]
    # churn within capacity: no generation bump, slot reused
    st.unregister(1)
    assert st.active_mask().tolist() == [1, 0, 1, 0]
    assert st.register(7) == 1
    st.write("params", 7, _row(9))
    assert st.stacked("params")["w"][1, 0, 0].item() == 9
    assert st.generation() == gen
    # growth past capacity pads every stacked tree and bumps the generation
    st.register(8)
    st.register(9)
    assert st.capacity == 8 and st.generation() == gen + 1
    assert st.stacked("params")["w"].shape[0] == 8


def test_store_flush_writes_rows_in_place_and_views_follow():
    st = ParticleStore(device="cpu")
    for pid in range(2):
        st.register(pid)
        st.write("params", pid, _row(pid))
    stacked = st.stacked("params")
    view = st.read("params", 1)
    st.write("params", 1, _row(5))
    assert st.stacked("params")["w"] is stacked["w"]       # no restack
    assert view["w"][0, 0].item() == 5                    # view of the row
    v0 = st.version("params")
    assert st.stacked("params") is not None and st.version("params") == v0


def test_store_checkout_commit_roundtrip():
    st = ParticleStore(device="cpu")
    for pid in range(2):
        st.register(pid)
    pool = {"k": torch.zeros(2, 4)}
    gen = st.generation()
    st.commit("kv_pages", pool)              # a new key: schema change
    assert st.generation() == gen + 1
    out = st.checkout("kv_pages")
    with pytest.raises(KeyError):
        st.stacked("kv_pages")               # ownership moved out
    out["k"][1] += 3                         # updated in place by a step
    st.commit("kv_pages", out)
    assert st.stacked("kv_pages")["k"][1].tolist() == [3.0] * 4
    with pytest.raises(ValueError):
        st.commit("kv_pages", {"k": torch.zeros(3, 4)})
    # a checkout that outlives a capacity growth is padded on commit
    out = st.checkout("kv_pages")
    st.register(2)
    st.commit("kv_pages", out)
    assert st.stacked("kv_pages")["k"].shape == (4, 4)


# ---------------------------------------------------------------------------
# DecodeScheduler on the port
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return configs.get("qwen1.5-0.5b").replace(
        n_units=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=128, max_seq_len=128)


def _pd(cfg, n=2):
    pd = PushDistribution(
        ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg),
        seed=0, device="cpu")
    for _ in range(n):
        pd.p_create()
    return pd


def test_scheduler_preemption_is_deterministic():
    """A pool too small for the load forces preemptions; greedy replay
    makes the output token-identical to an unconstrained run."""
    cfg = _tiny_cfg()
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, cfg.vocab_size, 12)) for _ in range(3)]
    gens = {}
    for num_pages in (64, 8):     # 3 seqs x 5 pages vs 8 pages: can't fit
        with _pd(cfg) as pd:
            svc = serve_decode(pd, cfg, num_pages=num_pages, page_size=4,
                               max_active=3, warmup=False)
            try:
                gens[num_pages] = [h.result(120) for h in
                                   [svc.generate_async(p, max_new=8)
                                    for p in prompts]]
                st = svc.stats()
            finally:
                svc.close()
    assert st["preempted"] > 0
    assert sum(g.preemptions for g in gens[8]) == st["preempted"]
    assert st["pool"]["used_pages"] == 0
    assert st["h2d_transfers"] == st["steps"] + st["prefills"]
    for a, b in zip(gens[64], gens[8]):
        assert a.tokens == b.tokens


def test_scheduler_eos_and_request_validation():
    cfg = _tiny_cfg()
    with _pd(cfg, n=1) as pd:
        svc = serve_decode(pd, cfg, num_pages=16, page_size=8, max_active=2,
                           cache_dtype=torch.bfloat16)
        try:
            # one k/v pair of leaves, stacked over the 2 layers
            assert svc.stats()["kv_pages"]["dtypes"] == {"bfloat16": 2}
            g = svc.generate([5, 9, 23], max_new=8)
            g2 = svc.generate([5, 9, 23], max_new=8, eos_id=g.tokens[0])
            assert g2.tokens == g.tokens[:1] and g2.finish_reason == "eos"
            with pytest.raises(ValueError):
                svc.generate([], max_new=4)
            with pytest.raises(ValueError):
                svc.generate([1], max_new=0)
            with pytest.raises(ValueError):     # exceeds pool capacity
                svc.generate([1] * 100, max_new=100)
        finally:
            svc.close()
