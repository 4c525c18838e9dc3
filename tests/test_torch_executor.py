"""The port's executor (``repro_torch.core.executor``) against the
scheduling semantics that ``tests/test_executor.py`` pins for the
reference: per-particle FIFO mailboxes, a fixed thread count,
cross-device concurrency, the context switch on wait, bounded queues,
graceful shutdown, wait-vs-run statistics, the wait timeout on a busy
queue, errors that leave the loop running. Plus the read-only snapshot a
``get`` returns and the executor's trace spans. The port imports no JAX,
so these run against it alone; every wait has a timeout."""
import threading
import time

import pytest
import torch

from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.executor import Executor
from repro_torch.core.messages import PFuture
from repro_torch.obs import trace
from repro_torch.optim import sgd

T = 10.0    # seconds any single wait may take before the test fails


def _executor(n_devices=1, **kw):
    ex = Executor(n_devices, **kw)
    for pid in range(8):
        ex.add_particle(pid, pid % n_devices)
    return ex


# ---------------------------------------------------------------------------
# scheduling semantics (tests/test_executor.py, against the port)
# ---------------------------------------------------------------------------

def test_mailbox_fifo_per_particle():
    """Messages to one particle run in send order; interleaved sends to a
    second particle must not reorder them."""
    ex = _executor()
    log = []
    futs = []
    for i in range(200):
        futs.append(ex.submit(0, lambda i=i: log.append(("p0", i))))
        futs.append(ex.submit(1, lambda i=i: log.append(("p1", i))))
    for f in futs:
        f.wait(T)
    ex.shutdown()
    for pid in ("p0", "p1"):
        seq = [i for p, i in log if p == pid]
        assert seq == sorted(seq), f"{pid} ran out of FIFO order"
    assert len(log) == 400


def test_no_thread_growth_across_1k_dispatches():
    """Workers are created once: 1k dispatches (device and lightweight)
    must not create a single extra thread."""
    ex = _executor()
    ex.submit(0, lambda: None).wait(T)      # warm up (starts the loops)
    before = threading.active_count()
    futs = [ex.submit(i % 8, lambda: None, lightweight=(i % 3 == 0))
            for i in range(1000)]
    during = threading.active_count()
    for f in futs:
        f.wait(T)
    after = threading.active_count()
    ex.shutdown()
    assert during <= before
    assert after <= before
    assert ex.stats()["completed"] >= 1001
    assert ex.stats()["threads"] == ex.num_threads


def test_cross_device_send_concurrency():
    """Two particles on different devices run truly concurrently: each
    handler blocks on a shared barrier that only opens when both arrived."""
    ex = _executor(n_devices=2)
    barrier = threading.Barrier(2, timeout=T)
    futs = [ex.submit(0, barrier.wait), ex.submit(1, barrier.wait)]
    for f in futs:
        f.wait(timeout=T)
    ex.shutdown()


def test_nested_send_and_wait_context_switch():
    """A handler that waits on work queued behind it on the SAME device
    must not deadlock: the worker context-switches into its queue."""
    ex = _executor(n_devices=1)

    def outer():
        inner = ex.submit(1, lambda: "inner-done")
        return inner.wait(timeout=T)

    assert ex.submit(0, outer).wait(timeout=T) == "inner-done"
    ex.shutdown()


def test_bounded_queue_backpressure():
    """External submitters block once a device queue holds max_pending
    messages: memory cannot grow without bound."""
    ex = Executor(1, max_pending=4)
    ex.add_particle(0, 0)
    release = threading.Event()
    first = ex.submit(0, lambda: release.wait(T))

    def flood():
        for _ in range(12):
            ex.submit(0, lambda: None)

    t = threading.Thread(target=flood, daemon=True)
    t.start()
    time.sleep(0.3)
    depth = max(ex.queue_depths())
    assert t.is_alive(), "submitter should be blocked on the full queue"
    assert depth <= 4
    release.set()
    t.join(timeout=T)
    assert not t.is_alive()
    assert first.wait(T) is True
    ex.drain(timeout=T)
    ex.shutdown()


def test_clean_shutdown_with_inflight_work():
    """shutdown(drain=True) finishes queued + running messages before the
    loops stop; nothing is dropped, no waiter hangs."""
    ex = _executor()
    done = []
    futs = [ex.submit(0, lambda i=i: (time.sleep(0.02), done.append(i))[1])
            for i in range(10)]
    ex.shutdown()
    assert sorted(done) == list(range(10))
    for f in futs:
        f.wait(timeout=1)
    with pytest.raises(RuntimeError):
        ex.submit(0, lambda: None)


def test_shutdown_rejects_leftovers_without_drain():
    ex = _executor()
    block = threading.Event()
    ex.submit(0, lambda: block.wait(5))
    stuck = [ex.submit(0, lambda: None) for _ in range(3)]
    ex.shutdown(drain=False, timeout=1)
    block.set()
    rejected = 0
    for f in stuck:
        try:
            f.wait(timeout=5)
        except RuntimeError:
            rejected += 1
    assert rejected >= 1


def test_dispatch_stats_wait_vs_run():
    ex = _executor()
    futs = [ex.submit(0, lambda: time.sleep(0.01)) for _ in range(5)]
    for f in futs:
        f.wait(T)
    st = ex.stats()
    ex.shutdown()
    assert st["dispatched"] == 5 and st["completed"] == 5
    assert st["run_time_s"] >= 5 * 0.01 * 0.5
    # later messages queued behind earlier ones -> nonzero wait time
    assert st["wait_time_s"] > 0
    assert st["max_queue_depth"] >= 2


def test_wait_timeout_fires_on_busy_queue():
    """A handler's wait(timeout) must raise even while the device queue
    keeps serving other work: a busy loop cannot starve the deadline."""
    ex = _executor()
    flood_stop = threading.Event()

    def keep_busy():
        if not flood_stop.is_set():
            ex.submit(2, keep_busy)  # queue never drains
        time.sleep(0.005)

    def outer():
        dangling = PFuture()
        t0 = time.monotonic()
        try:
            dangling.wait(timeout=0.3)
        except TimeoutError:
            return time.monotonic() - t0
        return None

    ex.submit(2, keep_busy)
    elapsed = ex.submit(0, outer).wait(timeout=T)
    flood_stop.set()
    ex.shutdown(drain=False, timeout=2)
    assert elapsed is not None, "wait(timeout) never raised on a busy queue"
    assert elapsed < 5.0


def test_errors_propagate_and_loop_survives():
    """A raising handler rejects its future but must not kill the worker."""
    ex = _executor()

    def boom():
        raise ValueError("boom")

    f1 = ex.submit(0, boom)
    with pytest.raises(ValueError, match="boom"):
        f1.wait(timeout=5)
    assert ex.submit(0, lambda: 42).wait(timeout=5) == 42
    ex.shutdown()


# ---------------------------------------------------------------------------
# particles on the executor: read-only views and trace spans
# ---------------------------------------------------------------------------

def _linear_module():
    """y = x @ w per particle, over the stacked particle axis."""
    def init(gen):
        return {"w": torch.randn((3, 2), generator=gen, device=gen.device)}

    def forward(p, batch):
        return torch.einsum("bi,pio->pbo", batch["x"], p["w"])

    def loss(p, batch):
        return ((forward(p, batch) - batch["y"]) ** 2).mean((1, 2)), {}

    return ParticleModule(init, loss, forward)


def _batch():
    x = torch.randn((8, 3), generator=torch.Generator().manual_seed(5))
    return {"x": x, "y": x @ torch.ones(3, 2)}


def test_get_view_is_a_snapshot():
    """A ``get`` view is a clone: it does not change when its owner
    updates in place, takes a step, or when a store flush rewrites the
    stacked rows its state is read from."""
    with PushDistribution(_linear_module(), device="cpu") as pd:
        a, b = pd.p_create(sgd(0.1)), pd.p_create(sgd(0.1))
        pd.particles[b].step(_batch()).wait(T)      # grads to snapshot
        pd.store.stacked("params")      # reads are views of the stack now
        view = pd.particles[a].get(b).wait(T)
        w0 = view.parameters()["w"].clone()
        g0 = view.gradients()["w"].clone()
        live = pd.p_params(b)["w"]
        assert live.data_ptr() != view.parameters()["w"].data_ptr()
        live.add_(1.0)                                # in place
        pd.particles[b].step(_batch()).wait(T)       # a step
        pd.store.stacked("params")                    # a flush in place
        assert torch.equal(view.parameters()["w"], w0)
        assert torch.equal(view.gradients()["w"], g0)
        assert not torch.equal(pd.p_params(b)["w"], w0)
        assert pd.nel.executor.stats()["pool_dispatched"] == 1


def test_executor_spans_emitted():
    """NEL dispatch: every work item gets an executor.run span carrying
    its queue + mailbox wait, on a named worker track
    (tests/test_obs.py, against the port)."""
    trace.clear()
    trace.enable()
    pd = PushDistribution(_linear_module(), device="cpu")
    try:
        for _ in range(3):
            pd.p_create()
        pd.p_predict({"x": torch.randn(4, 3)})
        pd.drain(T)
        runs = [s for s in trace.snapshot() if s["name"] == "executor.run"]
        assert len(runs) >= 3                       # one forward/particle
        assert all(s["cat"] == "executor" for s in runs)
        assert all(s["args"]["wait_ms"] >= 0 for s in runs)
        tracks = trace.TRACER.track_names()
        assert any(n.startswith("push-dev") for n in
                   (tracks.get(s["tid"], "") for s in runs))
        assert pd.stats()["obs"]["spans_recorded"] >= 3
    finally:
        trace.disable()
        trace.clear()
        pd.cleanup()
