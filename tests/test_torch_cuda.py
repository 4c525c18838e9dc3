"""Port tests that need an NVIDIA card (marker ``cuda``; skipped
elsewhere). They import no JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The paged-attention kernel is held against its plain PyTorch version on
the card on the ``tests/test_paged.py`` sweep with a particle axis of 2
and NaN in every stale slot, within 1e-4 with fp32 and with bf16 pages:
both sides widen the same bf16 values and accumulate in fp32, so bf16
pages leave no rounding gap between them. A small ``serve_decode`` then
runs on the card, where every decode step goes through the kernel, and on
the CPU, where the same weights take the plain version; both emit the
same tokens.

The SVGD and SWAG kernels are held against their plain versions on the
``tests/test_kernels.py`` sweeps, dense and masked with NaN in the dead
rows (sqdist 1e-3 absolute, force 2e-4 relative, moments and diag_std
1e-5; dead rows of phi exact zeros, dead SWAG rows unchanged); they refuse
non-contiguous and wrong-dtype inputs. The sqdist kernel also gives the
same bits twice, an exactly symmetric output with an exact-zero diagonal
that is the fixed-order sum of its first stage's partials bit for bit; it
takes plain loads where rows cannot be bulk-copied (D % 4 != 0, a base
not 16-byte aligned), holds at every ring depth, and at the training
shape (8 x 19,775,360) takes the bulk-copy path within 1e-5 of the
largest distance. Small SteinVGD and MultiSWAG runs
of the ViT on the card match the same runs on the CPU within 1e-4, with
one launch of each kernel per step, collection or sampled leaf. The
streamed force equals the column kernel (the probe
``svgd_force_columns``) bit for bit at n = 1-9, 16 and 256, on odd D, D % 4
== 0 and an unaligned view, masked, and into ``out=``; the one-launch
collection (``moments_leaves``) equals the per-leaf kernel and the plain
version bit for bit in place with dead rows, takes one launch per 64
leaves past them, and a captured collection replays the eager bits. The
one-launch diagonal scale (``diag_std_leaves``) equals the per-leaf
kernel bit for bit over the full-width ViT's and UNet's leaves at P = 1
and 8, an unaligned leaf, empty leaves and 65 leaves (two launches), a
captured call replays its bits, and it refuses CPU, half-precision and
mismatched inputs.

The window (speculative verify), prefill and dense-decode kernels are held
against their plain versions: the window kernel on the
``tests/test_speculative.py`` shapes plus the qwen serving heads with NaN
past every window and in unowned pages (1e-4, fp32 and bf16 pages; exact
zeros on inactive rows; W = 1 returns the single-token kernel's bits)
and on split page walks (page edges, one-split and many-split rows
in 256-page tables), the prefill kernel on the ``tests/test_kernels.py``
flash sweep plus longer ragged cases and a sweep of S, G and hd that no
tile divides (2e-5; bf16 2e-2) and under the prefix-LM mask at hd 64
and 256 with 1 and 8 query heads a kv head, the dense-decode kernel on
the decode sweeps with NaN in empty slots (2e-5; a row with every slot
empty is exact zeros). The single-token
paged and the dense-decode kernels walk each row split across blocks: both
are held against their plain versions on split walks (page and stage
edges, one-split and many-split rows, inactive rows, all-empty stages, a
row with no valid slot; fp32 and bf16; one and several kv heads a
block, one split and many), the paged kernel also through the draft's
one-particle view of a stacked pool. Speculative serving and
the stateful dense-cache engine on the card emit the CPU's tokens, with
one launch per layer per verify, prefill or step.

Step capture: each serving step (paged decode, prefill, the draft, the
verify window, the dense-cache step) captured as a CUDA graph and replayed
on new inputs gives the eager step's bits, outputs and pools alike, with
the same launches; after warmup, admission, retirement and preemption
capture nothing and the captured service's tokens and heads equal the
eager service's exactly; a params commit captures anew (no stale replay);
and the launch counters moved by replays equal the kernel launches the
profiler sees in the same window.

Train-step capture: DeepEnsemble, SteinVGD (ell = 1 and the median
heuristic) and MultiSWAG on a narrow ViT, with every train step, SWAG
collection and p_predict captured once and replayed, equal the eager run
from the same init bit for bit (state, losses, predictions), with the
same kernel launches and no capture after the first step. The moments
kernel updating mean and sq in place gives its out-of-place bits.

The precision ladder: the serve copy and the int8 draft's pack keep
their addresses across a clone and capture nothing, the clone's row in
the copy is its master's bf16 cast; the card's int8 packs equal the
CPU's bit for bit; the int8 draft's tokens equal plain decode's (fp32
and "mixed"); "mixed" training keeps fp32 masters and tracks fp32.

The actor runtime: NEL SteinVGD (the leader's dense force: one sqdist
and one force launch per step) and NEL MultiSWAG (one moments launch
per particle per collection, on one-row views) on a narrow ViT
match the compiled path on the card within 1e-4; a handler that sends
to another particle and waits on it finishes on the one device worker,
with the card current there. Every run is joined within a time limit.

The SciML workload: the full-width UNet's outputs, loss and grads on the
card equal the CPU's within 1e-5 of the largest (TF32 off); #1 and #2 at
the UNet's (8, 1,240,065) shape, #1 on its plain-load path (D is odd);
each Fig. 4 baseline on the card equals the CPU run, every program a
graph, one a NN; regression serving of a narrow UNet answers
single-example requests with ``predict_batch``'s rows and captures
nothing after warmup.

Obs: the device gauges read the caching allocator and the device total;
a captured program's cost is counted on its warm-up, a kernel charging
its own FLOPs and bytes.

LM training: a narrow qwen's DeepEnsemble steps (Adam under
warmup_cosine) captured equal the eager steps bit for bit; the chunked
flash attention's backward on the card equals ``full_attention``'s
autograd and the CPU's; a schedule is read with no host sync and a CUDA
graph of the update replays the eager bits.
"""
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.bdl import MultiSWAG, SteinVGD
from repro_torch.bdl import svgd as bsvgd
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataLoader
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import paged_decode_attention as kernel
from repro_torch.kernels import paged_decode_window_attention as window_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import svgd_rbf, swag_moments
from repro_torch.models import api
from repro_torch.optim import adam, sgd
from repro_torch.serve import PredictiveEngine, serve, serve_decode

pytestmark = pytest.mark.cuda

SWEEP = [
    (2, 4, 2, 32, 16, 4, [47, 63]),
    (3, 8, 1, 16, 8, 6, [0, 33, 21]),
    (2, 4, 4, 8, 16, 3, [-1, 40]),
    (4, 6, 3, 64, 32, 2, [5, -1, 63, 31]),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, P, B, H, KVH, hd, ps, n_pmax, lens, dtype, dev, NP=None):
    NP = NP or B * n_pmax + 2
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((P, B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32))
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    owned = set()
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        for i in range(sl // ps + 1):
            bt[b, i] = free.pop()
            owned.add(int(bt[b, i]))
        last = bt[b, sl // ps]
        k[:, last, sl % ps + 1:] = float("nan")
        v[:, last, sl % ps + 1:] = float("nan")
    for page in set(range(NP)) - owned:
        k[:, page] = float("nan")
        v[:, page] = float("nan")
    return (q.to(dev), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", SWEEP)
def test_kernel_matches_plain(dev, dtype, B, H, KVH, hd, ps, n_pmax, lens):
    args = _case(B * 7 + ps, 2, B, H, KVH, hd, ps, n_pmax, lens, dtype, dev)
    before = kernel.paged_decode_attention.launches
    out = kernel.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert kernel.paged_decode_attention.launches == before + 1
    want = ref.paged_decode_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert out[:, b].abs().max().item() == 0.0


def test_kernel_takes_particle_strided_pages(dev):
    """A layer's pages are a view of the stacked (P, n_units, ...) pool."""
    q, k, v, bt, sl = _case(3, 2, 2, 4, 2, 32, 16, 4, [47, 63],
                            torch.float32, dev)
    pool_k = torch.stack([torch.zeros_like(k), k], dim=1)   # (P, 2, ...)
    pool_v = torch.stack([torch.zeros_like(v), v], dim=1)
    out = kernel.paged_decode_attention(q, pool_k[:, 1], pool_v[:, 1], bt, sl)
    want = ref.paged_decode_attention(q, k, v, bt, sl)
    assert (out - want).abs().max().item() < 1e-4


def test_serve_decode_kernel_matches_plain(dev):
    """The card's serve_decode (kernel) against the same weights served on
    the CPU (plain version)."""
    cfg = configs.get("qwen1.5-0.5b").replace(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 512, int(rng.integers(3, 20))))
               for _ in range(5)]
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    gpu_pd = PushDistribution(module, seed=0, device=dev)
    cpu_pd = PushDistribution(module, device="cpu")
    for _ in range(2):
        pid = gpu_pd.p_create()
        cpu_pd.p_create(params=tree_map(lambda a: a.cpu(),
                                        gpu_pd.p_params(pid)))
    outs = []
    for pd in (gpu_pd, cpu_pd):
        svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=3)
        try:
            before = kernel.paged_decode_attention.launches
            gens = [h.result(120) for h in
                    [svc.generate_async(p, max_new=8) for p in prompts]]
            launches = kernel.paged_decode_attention.launches - before
            steps = svc.stats()["steps"]
        finally:
            svc.close()
        assert launches == (cfg.n_layers * steps if pd is gpu_pd else 0)
        outs.append(gens)
    for a, b in zip(*outs):
        assert a.tokens == b.tokens
        assert np.allclose(a.entropy, b.entropy, atol=1e-4)
        assert np.allclose(a.mutual_info, b.mutual_info, atol=1e-4)


SQDIST_SWEEP = [(2, 16), (4, 100), (8, 5000), (64, 12345), (3, 7)]
FORCE_SWEEP = [(4, 100, 1.0), (8, 5000, 1.3), (16, 50000, 0.7), (3, 7, 2.0)]


def _rows(seed, n, D, dev, dead=(), scale=0.05):
    """theta, grads (n, D) and a mask with NaN planted in the dead rows."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, D)).astype(np.float32) * scale
    g = rng.standard_normal((n, D)).astype(np.float32)
    m = np.ones(n, np.float32)
    m[list(dead)] = 0.0
    t[m == 0] = np.nan
    g[m == 0] = np.nan
    return (torch.from_numpy(t).to(dev), torch.from_numpy(g).to(dev),
            torch.from_numpy(m).to(dev) if dead else None)


def _plain_force(t, g, ell, m=None):
    """The SVGD force from the plain versions, past the kernels' dispatch."""
    sq = ref.pairwise_sqdist(t, m)
    return ref.svgd_force(t, g, *bsvgd.rbf_glue(sq, ell, m), m)


@pytest.mark.parametrize("n,D", SQDIST_SWEEP)
@pytest.mark.parametrize("masked", [False, True])
def test_sqdist_kernel_matches_plain(dev, n, D, masked):
    t, _, m = _rows(n * 3 + D, n, D, dev, dead=[n - 1] if masked else ())
    before = svgd_rbf.pairwise_sqdist.launches
    got = svgd_rbf.pairwise_sqdist(t, m)
    torch.cuda.synchronize()
    assert svgd_rbf.pairwise_sqdist.launches == before + 1
    want = ref.pairwise_sqdist(t, m)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-3
    assert torch.equal(got, got.T) and got.min().item() >= 0.0


SQDIST_EXTRA = [(72, 301), (9, 64), (256, 1000), (1, 100), (5, 4096)]


def _fixed_order_sum(partial):
    """The second stage's order on (n, n, nchunks) partials: lane l adds
    chunks l, l + 32, ... in order, then an xor-shuffle tree over the
    lanes; (i, j) and (j, i) from one sum, 0 on the diagonal."""
    n, _, nchunks = partial.shape
    iu, ju = torch.triu_indices(n, n, 1, device=partial.device)
    k = -(-nchunks // 32)
    lanes = torch.zeros((len(iu), k * 32), device=partial.device)
    lanes[:, :nchunks] = partial[iu, ju]
    lanes = lanes.reshape(len(iu), k, 32)
    s = torch.zeros((len(iu), 32), device=partial.device)
    for r in range(k):
        s = s + lanes[:, r]
    idx = torch.arange(32, device=partial.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    out = torch.zeros((n, n), device=partial.device)
    out[iu, ju] = s[:, 0]
    out[ju, iu] = s[:, 0]
    return out


@pytest.mark.parametrize("n,D", SQDIST_SWEEP + SQDIST_EXTRA)
@pytest.mark.parametrize("masked", [False, True])
def test_sqdist_kernel_deterministic_symmetric_zero_diagonal(dev, n, D,
                                                             masked):
    """Two calls give the same bits, the output is exactly symmetric with
    an exact-zero diagonal, and it is the fixed-order sum of the first
    stage's partials, bit for bit."""
    t, _, m = _rows(n * 5 + D, n, D, dev,
                    dead=[n - 1] if masked and n > 1 else ())
    a = svgd_rbf.pairwise_sqdist(t, m)
    b = svgd_rbf.pairwise_sqdist(t, m)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert torch.equal(a, a.T) and (a.diagonal() == 0).all()
    assert (a - ref.pairwise_sqdist(t, m)).abs().max().item() < 1e-3
    if n > 1:
        partial = svgd_rbf.pairwise_sqdist(t, m, reduce=False)
        assert torch.equal(_fixed_order_sum(partial), a)


@pytest.mark.parametrize("n,D,offset", [(3, 7, 0), (64, 12345, 0),
                                        (8, 4099, 0), (8, 4096, 1),
                                        (20, 1000, 3)])
def test_sqdist_kernel_plain_load_path(dev, n, D, offset):
    """Rows that cannot be bulk-copied (D % 4 != 0, or a base that is not
    16-byte aligned) take the plain loads, NaN in a dead row."""
    buf = torch.empty(n * D + offset, device=dev)
    t = buf[offset:].view(n, D)
    t.copy_(_rows(D + offset, n, D, dev, dead=[1])[0])
    m = torch.ones(n, device=dev)
    m[1] = 0.0
    assert svgd_rbf.plan_for(t).path == "plain"
    got = svgd_rbf.pairwise_sqdist(t, m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref.pairwise_sqdist(t, m)).abs().max().item() < 1e-3
    assert torch.equal(got, got.T) and (got.diagonal() == 0).all()


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_sqdist_kernel_ring_depths(dev, stages):
    """Every ring depth the probe times gives the plain version's
    distances, with NaN in dead rows (one of them in a second tile)."""
    t, _, m = _rows(stages, 12, 40000, dev, dead=[2, 9])
    got = svgd_rbf.pairwise_sqdist(t, m, stages=stages)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref.pairwise_sqdist(t, m)).abs().max().item() < 1e-3
    assert torch.equal(got, got.T) and (got.diagonal() == 0).all()


def test_sqdist_kernel_at_the_training_shape(dev):
    """8 ViT-MNIST particles x 19,775,360: the bulk-copy path, within 1e-5
    of the largest distance (~1e5) of the plain version, the same bits
    twice."""
    gen = torch.Generator(device=dev).manual_seed(40)
    t = torch.randn((8, 19_775_360), generator=gen, device=dev) * 0.05
    assert svgd_rbf.plan_for(t).path == "bulk"
    a = svgd_rbf.pairwise_sqdist(t)
    b = svgd_rbf.pairwise_sqdist(t)
    want = ref.pairwise_sqdist(t)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, a.T) and (a.diagonal() == 0).all()
    assert ((a - want).abs().max() / want.abs().max()).item() < 1e-5


@pytest.mark.parametrize("n,D,ell", FORCE_SWEEP + [(8, 5000, 0.0),
                                                   (16, 50000, -1.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_force_kernel_matches_plain(dev, n, D, ell, masked):
    dead = [0, n - 1] if masked and n > 3 else ([1] if masked else ())
    t, g, m = _rows(n * 5 + D, n, D, dev, dead=dead)
    before = svgd_rbf.svgd_force.launches
    got = bsvgd.svgd_force(t, g, ell, mask=m)
    torch.cuda.synchronize()
    assert svgd_rbf.svgd_force.launches == before + 1
    want = _plain_force(t, g, ell, m)
    assert torch.isfinite(got).all()
    rel = (got - want).abs().max().item() / (want.abs().max().item() + 1e-9)
    assert rel < 2e-4
    if masked:
        assert got[m == 0].abs().max().item() == 0.0


@pytest.mark.parametrize("n,D,ell", [(8, 5000, 0.0), (16, 50000, -1.0)])
def test_force_kernel_repulsive_term_alone(dev, n, D, ell):
    """With g = 0, phi is only the repulsive term, which the driving term
    would swamp at a small lengthscale-scaled magnitude."""
    t, _, m = _rows(n * 7 + D, n, D, dev, dead=[1])
    g = torch.zeros_like(t)
    got = bsvgd.svgd_force(t, g, ell, mask=m)
    want = _plain_force(t, g, ell, m)
    assert want.abs().max().item() > 0.0
    rel = (got - want).abs().max().item() / want.abs().max().item()
    assert rel < 2e-4


def test_force_kernel_tiles_receiving_rows_at_n_256(dev):
    """K^T / n at n = 256 exceeds a block's shared memory: row tiles."""
    t, g, _ = _rows(256, 256, 3000, dev)
    got = bsvgd.svgd_force(t, g, 0.0)
    want = _plain_force(t, g, 0.0)
    rel = (got - want).abs().max().item() / want.abs().max().item()
    assert rel < 2e-4


@pytest.mark.parametrize("P,shape,dead", [(3, (123,), ()), (4, (7, 3), (1,)),
                                          (8, (8193,), (0, 5))])
def test_moments_kernel_matches_plain(dev, P, shape, dead):
    rng = np.random.default_rng(P)
    R = 4

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

    mean, theta = arr(P, *shape), arr(P, *shape)
    sq = mean ** 2 + arr(P, *shape).abs()
    ring = arr(P, R, *shape)
    n = torch.arange(P, dtype=torch.float32, device=dev)
    slot = torch.tensor([(3 * p) % R for p in range(P)], dtype=torch.int32,
                        device=dev)
    m = torch.ones(P, device=dev)
    m[list(dead)] = 0.0
    theta[m == 0] = float("nan")
    ring_k, ring_p, ring_l = ring.clone(), ring.clone(), ring.clone()
    before = swag_moments.moments.launches
    got = swag_moments.moments(mean, sq, theta, n, m, ring_k, slot)
    torch.cuda.synchronize()
    assert swag_moments.moments.launches == before + 1
    want = ref.swag_moments(mean, sq, theta, n, m, ring_p, slot)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() < 1e-5
    assert (ring_k - ring_p).abs().max().item() < 1e-5
    for p in dead:
        assert torch.equal(got[0][p], mean[p]) and torch.equal(got[1][p], sq[p])
        assert torch.equal(ring_k[p], ring[p])
    # the one-launch kernel on this one leaf, in place: the same bits
    ml, sl = mean.clone(), sq.clone()
    before = swag_moments.moments_leaves.launches
    swag_moments.moments_leaves([ml], [sl], [theta], n, m, [ring_l], slot)
    torch.cuda.synchronize()
    assert swag_moments.moments_leaves.launches == before + 1
    assert torch.equal(ml, got[0]) and torch.equal(sl, got[1])
    assert torch.equal(ring_l, ring_k)


@pytest.mark.parametrize("P,shape,dead", [(3, (123,), ()), (4, (7, 3), (1,)),
                                          (8, (8193,), (0, 5))])
def test_moments_kernel_in_place(dev, P, shape, dead):
    """out_mean=mean, out_sq=sq (what the SWAG collection passes) gives
    the out-of-place kernel's bits, ring included, and leaves a dead row
    as it was; an output may alias only its own moment."""
    rng = np.random.default_rng(P + 1)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

    mean, theta = arr(P, *shape), arr(P, *shape)
    sq = mean ** 2 + arr(P, *shape).abs()
    ring = arr(P, 4, *shape)
    n = torch.arange(P, dtype=torch.float32, device=dev)
    slot = torch.tensor([(3 * p) % 4 for p in range(P)], dtype=torch.int32,
                        device=dev)
    m = torch.ones(P, device=dev)
    m[list(dead)] = 0.0
    theta[m == 0] = float("nan")
    ring_o, ring_i = ring.clone(), ring.clone()
    want = swag_moments.moments(mean, sq, theta, n, m, ring_o, slot)
    mi, si = mean.clone(), sq.clone()
    got = swag_moments.moments(mi, si, theta, n, m, ring_i, slot,
                               out_mean=mi, out_sq=si)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == mi.data_ptr()
    assert got[1].data_ptr() == si.data_ptr()
    assert torch.equal(mi, want[0]) and torch.equal(si, want[1])
    assert torch.equal(ring_i, ring_o)
    for p in dead:
        assert torch.equal(mi[p], mean[p]) and torch.equal(si[p], sq[p])
    for out in ({"out_mean": sq}, {"out_sq": mean}, {"out_mean": theta}):
        with pytest.raises(ValueError, match="alias"):
            swag_moments.moments(mean, sq, theta, n, m, **out)


STREAM_N = [1, 2, 3, 4, 7, 8, 9, 16, 256]


def _force_layout(t, g, layout):
    """theta and grads as the layout asks: as they are, or copied into
    views one float past a 16-byte boundary (the scalar path)."""
    if layout != "unaligned":
        return t, g
    views = []
    for x in (t, g):
        buf = torch.empty(x.numel() + 1, device=x.device)
        v = buf[1:].view(x.shape)
        v.copy_(x)
        views.append(v)
    return views


@pytest.mark.parametrize("n", STREAM_N)
@pytest.mark.parametrize("layout,D", [("odd", 3001), ("div4", 4100),
                                      ("unaligned", 4100)])
def test_force_stream_kernel_equals_column_kernel(dev, n, D, layout):
    """The streamed force gives the column kernel's bits, dead rows (NaN in
    them) exact zeros, into a new tensor and into ``out=``."""
    if n == 256:                    # keep the n = 256 cases small
        D = 1001 if layout == "odd" else 1024
    dead = [0, n - 1] if n > 3 else ([1] if n > 1 else [])
    t, g, m = _rows(n * 11 + D, n, D, dev, dead=dead)
    t, g = _force_layout(t, g, layout)
    glue = bsvgd.rbf_glue(ref.pairwise_sqdist(t, m), 0.0, m)
    path = svgd_rbf.force_plan_for(t, g, torch.empty_like(t)).path
    assert path == ("vector" if layout == "div4" else "scalar")
    before = svgd_rbf.svgd_force.launches
    got = svgd_rbf.svgd_force(t, g, *glue, m)
    torch.cuda.synchronize()
    assert svgd_rbf.svgd_force.launches == before + 1
    want = svgd_rbf.svgd_force_columns(t, g, *glue, m)
    assert torch.equal(got, want)
    out = torch.full_like(got, float("nan"))
    assert svgd_rbf.svgd_force(t, g, *glue, m, out=out) is out
    assert torch.equal(out, want)
    if m is not None:
        assert (got[m == 0] == 0).all()
    plain = ref.svgd_force(t, g, *glue, m)
    assert (got - plain).abs().max().item() < 2e-4 * plain.abs().max().item()
    with pytest.raises(ValueError, match="out"):
        svgd_rbf.svgd_force(t, g, *glue, m, out=t)


def _leaf_tree(dev, P, shapes, R=4, dead=(1,), seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    means = [rnd(P, *s) for s in shapes]
    sqs = [x * x + rnd(*x.shape).abs() for x in means]
    thetas = [rnd(P, *s) for s in shapes]
    devs = [rnd(P, R, *s) for s in shapes]
    n = torch.arange(P, dtype=torch.float32, device=dev) + 1
    slot = (torch.arange(P, device=dev) * 3 % R).to(torch.int32)
    m = torch.ones(P, device=dev)
    m[list(dead)] = 0.0
    for t in thetas:
        t[m == 0] = float("nan")
    return means, sqs, thetas, devs, n, slot, m


# a UNet-like tree (odd widths, 1-element biases), a ViT-like one, and
# 150 leaves: more than one launch holds
LEAF_TREES = {"unet": [(3, 1, 8), (8,), (3, 8, 16), (16,), (5, 7), (1,),
                       (4096,), (12289,)],
              "vit": [(64, 256), (256,), (256, 768), (768,), (2048,)],
              "many": [(37,), (64,), (1,)] * 50}


@pytest.mark.parametrize("tree", sorted(LEAF_TREES))
def test_moments_leaves_kernel_equals_per_leaf_kernel(dev, tree):
    """One collection over every leaf in place: the per-leaf kernel's and
    the plain version's bits, dead rows untouched, one launch per 64
    leaves."""
    shapes = LEAF_TREES[tree]
    means, sqs, thetas, devs, n, slot, m = _leaf_tree(dev, 8, shapes)
    got = [[x.clone() for x in xs] for xs in (means, sqs, devs)]
    before = swag_moments.moments_leaves.launches
    out = swag_moments.moments_leaves(got[0], got[1], thetas, n, m, got[2],
                                      slot)
    torch.cuda.synchronize()
    assert swag_moments.moments_leaves.launches - before == \
        -(-len(shapes) // swag_moments.MAX_LEAVES)
    assert out[0] is got[0] and out[1] is got[1]
    for i in range(len(shapes)):
        rk, rp = devs[i].clone(), devs[i].clone()
        k = swag_moments.moments(means[i], sqs[i], thetas[i], n, m, rk, slot)
        p = ref.swag_moments(means[i], sqs[i], thetas[i], n, m, rp, slot)
        for a, b, c in zip((got[0][i], got[1][i], got[2][i]), k + (rk,),
                           p + (rp,)):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(got[0][i][1], means[i][1])
        assert torch.equal(got[2][i][1], devs[i][1])


def test_captured_collection_replays_the_eager_bits(dev):
    """A CUDA graph of the one-launch collection, replayed, gives the eager
    collection's bits from the same state."""
    means, sqs, thetas, devs, n, slot, m = _leaf_tree(
        dev, 8, LEAF_TREES["unet"], seed=3)
    state = lambda: [[x.clone() for x in xs] for xs in (means, sqs, devs)]
    eager, graphed, warm = state(), state(), state()
    swag_moments.moments_leaves(eager[0], eager[1], thetas, n, m, eager[2],
                                slot)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        swag_moments.moments_leaves(warm[0], warm[1], thetas, n, m, warm[2],
                                    slot)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        swag_moments.moments_leaves(graphed[0], graphed[1], thetas, n, m,
                                    graphed[2], slot)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(sum(eager, []), sum(graphed, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [1, 123, 8192, 8193, 100000])
def test_diag_std_kernel_matches_plain(dev, D):
    rng = np.random.default_rng(D)
    mean = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32)).to(dev)
    sq = mean ** 2 + torch.from_numpy(
        np.abs(rng.standard_normal((2, D))).astype(np.float32)).to(dev)
    sq[0, :D // 2] = 0.5 * mean[0, :D // 2] ** 2 - 1e-3
    before = swag_moments.diag_std.launches
    got = swag_moments.diag_std(mean, sq)
    torch.cuda.synchronize()
    assert swag_moments.diag_std.launches == before + 1
    assert (got - ref.diag_std(mean, sq)).abs().max().item() < 1e-5


def _model_leaf_shapes(name):
    """One particle's leaf shapes at full width, in the sampling path's
    order (sorted key paths), from an init on the meta device."""
    from repro_torch.core.tree import tree_flatten
    cfg = configs.get(name)
    with torch.device("meta"):
        params = api.init_params(torch.Generator(), cfg)
    return [tuple(x.shape) for x in tree_flatten(params, sort_keys=True)[0]]


def _diag_case(dev, P, shapes, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    means = [torch.randn((P,) + s, generator=gen, device=dev) * 0.1
             for s in shapes]
    sqs = [m * m + torch.rand(m.shape, generator=gen, device=dev) * 1e-3
           for m in means]
    for s in sqs[::3]:                  # clamped at 1e-30
        s.view(-1)[::5] = 0.0
    return means, sqs


def _unaligned(x):
    """A contiguous copy of ``x`` one float past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


DIAG_TREES = {"many": [(37,), (64,), (1,), (0,)] * 16 + [(5,)],  # 49 live
              "sixty_five": [(3, 7)] * 65,
              "empty": [(0,), (16,), (0, 3), (5,)]}


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("tree", ["vit-mnist", "unet-advection",
                                  *sorted(DIAG_TREES)])
def test_diag_std_leaves_kernel_equals_per_leaf_kernel(dev, tree, P):
    """#4 over every leaf: the per-leaf kernel's bits (and the plain
    version within 1e-5), one launch per 64 non-empty leaves, each scale
    a contiguous tensor shaped like its mean; a leaf one float past a
    16-byte boundary takes the scalar path with the same bits."""
    shapes = (DIAG_TREES[tree] if tree in DIAG_TREES
              else _model_leaf_shapes(tree))
    means, sqs = _diag_case(dev, P, shapes, seed=len(shapes) + P)
    if tree == "many":
        means[5], sqs[5] = _unaligned(means[5]), _unaligned(sqs[5])
    live = sum(1 for m in means if m.numel())
    before = swag_moments.diag_std_leaves.launches
    got = swag_moments.diag_std_leaves(means, sqs)
    torch.cuda.synchronize()
    assert swag_moments.diag_std_leaves.launches - before == \
        -(-live // swag_moments.MAX_LEAVES)
    assert len(got) == len(means)
    for g, m, s in zip(got, means, sqs):
        assert g.shape == m.shape and g.is_contiguous() and g.is_cuda
        if m.numel():
            assert torch.equal(g, swag_moments.diag_std(m, s))
            assert (g - ref.diag_std(m, s)).abs().max().item() < 1e-5


def test_diag_std_leaves_refuses_bad_inputs(dev):
    t = torch.randn(4, 64, device=dev)
    cases = [([t, t.cpu()], [t, t.cpu()]),
             ([t, t], [t, t.half()]),
             ([t.half()], [t.half()]),
             ([t, t], [t, t[:, :32]]),                  # mismatched shape
             ([t.T], [t.T]),                            # strided
             ([t, t], [t]),                             # one sq short
             ([], [])]
    for means, sqs in cases:
        before = swag_moments.diag_std_leaves.launches
        with pytest.raises(ValueError):
            swag_moments.diag_std_leaves(means, sqs)
        assert swag_moments.diag_std_leaves.launches == before


def test_captured_diag_std_leaves_replays_the_eager_bits(dev):
    means, sqs = _diag_case(dev, 8, _model_leaf_shapes("unet-advection"))
    eager = swag_moments.diag_std_leaves(means, sqs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        swag_moments.diag_std_leaves(means, sqs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = swag_moments.diag_std_leaves(means, sqs)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, graphed):
        assert torch.equal(a, b)


def test_new_kernels_refuse_bad_inputs(dev):
    t = torch.randn(4, 64, device=dev)
    one = torch.ones(4, device=dev)
    cases = [
        (svgd_rbf.pairwise_sqdist, (t.T.contiguous().T,)),       # strided
        (svgd_rbf.pairwise_sqdist, (t.double(),)),
        (svgd_rbf.pairwise_sqdist, (t, torch.ones(3, device=dev))),
        (svgd_rbf.svgd_force, (t, t.double(), torch.ones(4, 4, device=dev),
                               one, torch.ones(1, device=dev))),
        (svgd_rbf.svgd_force, (t, t, torch.ones(4, 3, device=dev), one,
                               torch.ones(1, device=dev))),
        (swag_moments.moments, (t, t, t.T.contiguous().T, one)),
        (swag_moments.moments, (t, t, t, one.int())),
        (swag_moments.moments, (t, t, t, one, None, torch.zeros(4, 2, 64,
                                                                device=dev),
                                one)),
        (swag_moments.diag_std, (t, t.half())),
        (swag_moments.diag_std, (t.cpu(), t.cpu())),
    ]
    for fn, args in cases:
        before = fn.launches
        with pytest.raises(ValueError):
            fn(*args)
        assert fn.launches == before


def _vit_modules(dev, P):
    cfg = configs.get("vit-mnist").replace(n_units=2, d_model=64, n_heads=4,
                                           n_kv_heads=4, d_ff=128)
    gen = torch.Generator().manual_seed(0)
    inits = [api.init_params(gen, cfg) for _ in range(P)]
    mods = []
    for _ in range(2):
        it = iter(inits)
        mods.append(ParticleModule(lambda g, it=it: next(it),
                                   lambda p, b: api.loss_fn(p, b, cfg),
                                   lambda p, b: api.forward(p, b, cfg)[0],
                                   cfg=cfg))
    return cfg, mods


def _close(a, b, tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert (x.cpu() - y.cpu()).abs().max().item() < tol


def test_svgd_training_on_card_matches_cpu(dev):
    """6 particles in a store of capacity 8, median heuristic: every step
    launches sqdist and the force once on the card."""
    cfg, (mod_gpu, mod_cpu) = _vit_modules(dev, 6)
    out = {}
    for d, mod in ((dev, mod_gpu), (torch.device("cpu"), mod_cpu)):
        algo = SteinVGD(mod, backend="compiled", capacity=8, device=d)
        before = (svgd_rbf.pairwise_sqdist.launches,
                  svgd_rbf.svgd_force.launches)
        _, losses = algo.bayes_infer(DataLoader(cfg, batch_size=8,
                                                num_batches=2), 2,
                                     num_particles=6, lengthscale=0.0,
                                     lr=0.05)
        launches = (svgd_rbf.pairwise_sqdist.launches - before[0],
                    svgd_rbf.svgd_force.launches - before[1])
        assert launches == ((4, 4) if d == dev else (0, 0))
        out[d.type] = (algo.p_parameters(), losses)
    _close(out["cuda"][0], out["cpu"][0], 1e-4)
    assert np.allclose(out["cuda"][1], out["cpu"][1], atol=1e-4)


def test_multiswag_on_card_matches_cpu(dev):
    cfg, (mod_gpu, mod_cpu) = _vit_modules(dev, 4)
    n_leaves = None
    out = {}
    images = DataLoader(cfg, batch_size=6, num_batches=1, seed=1)
    batch = next(iter(images))
    for d, mod in ((dev, mod_gpu), (torch.device("cpu"), mod_cpu)):
        algo = MultiSWAG(mod, backend="compiled", device=d)
        before = swag_moments.moments_leaves.launches
        algo.bayes_infer(DataLoader(cfg, batch_size=8, num_batches=2), 3,
                         optimizer=sgd(0.05), num_particles=4,
                         pretrain_epochs=1, max_rank=3)
        n_leaves = len(tree_leaves(algo.p_parameters()[0]))
        # one launch a collection (the tree's leaves are under 64)
        assert swag_moments.moments_leaves.launches - before == \
            (2 if d == dev else 0)
        gen = torch.Generator(device=d).manual_seed(5)
        noise_gen = torch.Generator().manual_seed(5)
        swag = algo.store.dense("swag")
        z1 = tree_map(lambda m: torch.randn((4, 3) + tuple(m.shape[1:]),
                                            generator=noise_gen).to(d),
                      swag["mean"])
        z2 = torch.randn((4, 3, 3), generator=noise_gen).to(d)
        before = swag_moments.diag_std_leaves.launches
        heads = algo.posterior_predictive(
            samples_per_particle=3, noise=(z1, z2),
            generator=gen).predict_batch(batch)
        # one launch over every leaf (the tree's leaves are under 64)
        assert n_leaves < swag_moments.MAX_LEAVES
        assert swag_moments.diag_std_leaves.launches - before == \
            (1 if d == dev else 0)
        out[d.type] = (algo.p_parameters(), swag, heads)
    _close(out["cuda"][0], out["cpu"][0], 1e-4)
    _close(out["cuda"][1], out["cpu"][1], 1e-4)
    _close(out["cuda"][2], out["cpu"][2], 1e-4)


# --------------------------------------------------------------------------
# the three attention kernels of the LM's serving paths: speculative verify
# window, prefill, dense-cache decode
# --------------------------------------------------------------------------

WINDOW_SWEEP = [
    (2, 3, 4, 2, 16, 8, 4, [13, 20]),        # GQA, mixed lengths
    (3, 5, 8, 1, 8, 4, 8, [0, 9, 17]),       # MQA, window > page
    (2, 2, 4, 4, 8, 8, 3, [-1, 11]),         # MHA + inactive row
    (8, 5, 16, 16, 64, 16, 16, [40, 17, -1, 100, 63, 0, 77, 200]),  # qwen
]


def _window_case(seed, P, B, W, H, KVH, hd, ps, n_pmax, lens, dtype, dev):
    """Window q and pages with the PagePool conventions; NaN in every slot
    past each row's window (sl + W - 1) and in every page no row owns."""
    NP = B * n_pmax + 2
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((P, B, W, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    owned = set()
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        last = sl + W - 1
        for i in range(last // ps + 1):
            bt[b, i] = free.pop()
            owned.add(int(bt[b, i]))
        k[:, bt[b, last // ps], last % ps + 1:] = float("nan")
        v[:, bt[b, last // ps], last % ps + 1:] = float("nan")
    dead = sorted(set(range(NP)) - owned)
    k[:, dead] = float("nan")
    v[:, dead] = float("nan")
    return (q.to(dev), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KVH,hd,ps,n_pmax,lens", WINDOW_SWEEP)
def test_window_kernel_matches_plain(dev, dtype, B, W, H, KVH, hd, ps,
                                     n_pmax, lens):
    args = _window_case(B * 3 + W, 2, B, W, H, KVH, hd, ps, n_pmax, lens,
                        dtype, dev)
    before = window_kernel.paged_decode_window_attention.launches
    out = window_kernel.paged_decode_window_attention(*args)
    torch.cuda.synchronize()
    assert window_kernel.paged_decode_window_attention.launches == before + 1
    want = ref.paged_decode_window_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert out[:, b].abs().max().item() == 0.0


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", SWEEP)
def test_window_kernel_w1_matches_single_token_kernel(dev, B, H, KVH, hd, ps,
                                                      n_pmax, lens):
    q, k, v, bt, sl = _case(B * 7 + ps, 2, B, H, KVH, hd, ps, n_pmax, lens,
                            torch.float32, dev)
    single = kernel.paged_decode_attention(q, k, v, bt, sl)
    window = window_kernel.paged_decode_window_attention(q[:, :, None], k, v,
                                                         bt, sl)
    assert (window[:, :, 0] - single).abs().max().item() == 0.0


FLASH_SWEEP = [
    (1, 64, 4, 2, 32, True),
    (2, 50, 4, 1, 16, True),
    (1, 128, 8, 8, 64, False),
    (2, 33, 2, 2, 8, True),
    (1, 200, 16, 16, 64, True),      # qwen heads, ragged last tiles
    (1, 77, 16, 2, 128, False),      # hd 128, bidirectional ragged
]


@pytest.mark.parametrize("B,S,H,KVH,hd,causal", FLASH_SWEEP)
def test_flash_kernel_matches_plain(dev, B, S, H, KVH, hd, causal):
    gen = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((2, B, S, H, hd), generator=gen, device=dev)
    k = torch.randn((2, B, S, KVH, hd), generator=gen, device=dev)
    v = torch.randn((2, B, S, KVH, hd), generator=gen, device=dev)
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert (out - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_dtypes(dev, dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((2, 1, 64, h, 32), generator=gen,
                           device=dev).to(dtype) for h in (4, 2, 2))
    out = flash_kernel.flash_attention(q, k, v, causal=True)
    assert out.dtype == dtype
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True)
    assert (out.float() - want).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [8, 12, 16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("S", [1, 33, 200, 1000])
def test_flash_kernel_tile_edges(dev, S, G, hd, causal, dtype, tol):
    """S a multiple of no tile, any hd up to 128 (12: padded dims), G up to
    8 heads in a tile's rows; 3xTF32 in fp32, bf16 mma in bf16."""
    gen = torch.Generator(device=dev).manual_seed(S * 131 + G * 7 + hd)
    q, k, v = (torch.randn((2, 1, S, h, hd), generator=gen,
                           device=dev).to(dtype) for h in (2 * G, 2, 2))
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() < tol


WINDOW_SPLIT_CASES = [
    # page edges: seq_len at the last slot of a page, at the first, and a
    # window crossing an edge; a one-split row (0) beside many-split rows
    # (300, 2000) in 256-page tables (n_pmax far above most rows' pages)
    (8, 5, 8, 2, 64, 16, 256, [15, 16, 12, 11, -1, 0, 300, 2000]),
    (4, 3, 4, 4, 32, 8, 128, [7, 8, 1000, -1]),
    (3, 1, 16, 16, 64, 16, 256, [31, 32, 1500]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KVH,hd,ps,n_pmax,lens", WINDOW_SPLIT_CASES)
def test_window_kernel_split_walk(dev, dtype, B, W, H, KVH, hd, ps, n_pmax,
                                  lens):
    args = _window_case(B * 5 + W + ps, 2, B, W, H, KVH, hd, ps, n_pmax,
                        lens, dtype, dev)
    before = window_kernel.paged_decode_window_attention.launches
    out = window_kernel.paged_decode_window_attention(*args)
    torch.cuda.synchronize()
    assert window_kernel.paged_decode_window_attention.launches == before + 1
    want = ref.paged_decode_window_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert out[:, b].abs().max().item() == 0.0


DECODE_SWEEP = [
    (2, 64, 4, 2, 32, False),
    (1, 100, 8, 1, 16, True),
    (3, 33, 4, 4, 8, True),
    (2, 7, 4, 2, 16, False),
    (2, 65, 4, 2, 16, False),
    (8, 97, 16, 16, 64, True),       # qwen heads, C = 97
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,KVH,hd,holes", DECODE_SWEEP)
def test_decode_kernel_matches_plain(dev, dtype, B, C, H, KVH, hd, holes):
    """Empty slots (k_pos < 0) hold NaN; neither side may leak it."""
    gen = torch.Generator(device=dev).manual_seed(C)
    q = torch.randn((2, B, H, hd), generator=gen, device=dev)
    k = torch.randn((2, B, C, KVH, hd), generator=gen, device=dev)
    v = torch.randn((2, B, C, KVH, hd), generator=gen, device=dev)
    pos = torch.arange(C, device=dev).expand(B, C).clone()
    if holes:
        keep = torch.rand((B, C), generator=gen, device=dev) < 0.8
        pos = torch.where(keep, pos, -1)
    pos[:, -3:] = -1                       # decode headroom
    k[:, pos < 0] = float("nan")
    v[:, pos < 0] = float("nan")
    args = (q, k.to(dtype), v.to(dtype), pos.to(torch.int32))
    before = decode_kernel.decode_attention.launches
    out = decode_kernel.decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.launches == before + 1
    want = ref.decode_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 2e-5


def test_decode_kernel_takes_particle_strided_cache(dev):
    """A layer's cache is a view of the stacked (P, n_units, ...) cache."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 3, 4, 16), generator=gen, device=dev)
    k, v = (torch.randn((2, 2, 3, 20, 2, 16), generator=gen, device=dev)
            for _ in range(2))
    pos = torch.arange(20, device=dev, dtype=torch.int32).expand(3, 20)
    pos = pos.contiguous()
    out = decode_kernel.decode_attention(q, k[:, 1], v[:, 1], pos)
    want = ref.decode_attention(q, k[:, 1].contiguous(),
                                v[:, 1].contiguous(), pos)
    assert (out - want).abs().max().item() < 2e-5


PAGED_SPLIT_CASES = [
    # page edges (last slot of a page, first slot of the next), inactive
    # rows, one-split rows (0, 15) beside many-split rows (300, 2000) in
    # 256-page tables; qwen heads (G = 1: two kv heads a block with fp32
    # pages, four with bf16), GQA, MQA; 16 qwen rows make a grid of a
    # block per SM or more (fp32), whose rows do not split
    (8, 16, 16, 64, 16, 256, [15, 16, 31, -1, 0, 300, 2000, 97]),
    (16, 16, 16, 64, 16, 256, [100, 2047, -1, 16] * 4),
    (4, 8, 2, 64, 16, 256, [32, 1999, -1, 47]),
    (3, 8, 1, 32, 8, 128, [7, 8, 1000]),
    (2, 4, 4, 16, 4, 64, [255, 3]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", PAGED_SPLIT_CASES)
def test_paged_kernel_split_walk(dev, dtype, B, H, KVH, hd, ps, n_pmax, lens):
    """The split page walk against the plain version, NaN in stale and
    unowned slots; the window kernel at W = 1 returns the same bits."""
    q, k, v, bt, sl = _case(B * 11 + ps, 2, B, H, KVH, hd, ps, n_pmax, lens,
                            dtype, dev, NP=sum(L // ps + 1 for L in lens) + 9)
    before = kernel.paged_decode_attention.launches
    out = kernel.paged_decode_attention(q, k, v, bt, sl)
    torch.cuda.synchronize()
    assert kernel.paged_decode_attention.launches == before + 1
    want = ref.paged_decode_attention(q, k, v, bt, sl)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert out[:, b].abs().max().item() == 0.0
    window = window_kernel.paged_decode_window_attention(q[:, :, None], k, v,
                                                         bt, sl)
    assert (window[:, :, 0] - out).abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_one_particle_view(dev, dtype):
    """The speculative draft's call: a one-particle view (``a[s:s+1]``) of
    a stacked 4-particle pool, whose particle stride the kernel never
    uses."""
    q, k, v, bt, sl = _case(17, 4, 8, 16, 16, 64, 16, 256,
                            [100, 37, -1, 128, 15, 16, 2000, 64], dtype, dev,
                            NP=300)
    for s in (0, 3):
        out = kernel.paged_decode_attention(q[s:s + 1], k[s:s + 1],
                                            v[s:s + 1], bt, sl)
        want = ref.paged_decode_attention(q[s:s + 1], k[s:s + 1].contiguous(),
                                          v[s:s + 1].contiguous(), bt, sl)
        assert torch.isfinite(out).all()
        assert (out - want).abs().max().item() < 1e-4
        assert out[:, 2].abs().max().item() == 0.0


DECODE_SPLIT_CASES = [
    # C at and around stage edges, one split (C <= 32) and many (2048),
    # holes, all-empty stages (a run of 70 empty slots), a row with no
    # valid slot, a ragged last stage; qwen heads, GQA
    (4, 32, 16, 16, 64, "holes"),
    (3, 33, 8, 2, 64, "gap"),
    (8, 97, 16, 16, 64, "tail"),
    (2, 257, 4, 1, 32, "gap"),
    (2, 2048, 16, 16, 64, "holes"),
    (3, 300, 4, 4, 16, "empty_row"),
    (16, 300, 16, 16, 64, "holes"),  # a block per SM or more: no split
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,KVH,hd,empty", DECODE_SPLIT_CASES)
def test_decode_kernel_split_walk(dev, dtype, B, C, H, KVH, hd, empty):
    gen = torch.Generator(device=dev).manual_seed(C + B)
    q = torch.randn((2, B, H, hd), generator=gen, device=dev)
    k = torch.randn((2, B, C, KVH, hd), generator=gen, device=dev)
    v = torch.randn((2, B, C, KVH, hd), generator=gen, device=dev)
    pos = torch.arange(C, device=dev).expand(B, C).clone()
    if empty == "holes":
        pos = torch.where(torch.rand((B, C), generator=gen, device=dev) < 0.8,
                          pos, -1)
    elif empty == "gap":
        pos[:, 1:71] = -1
    elif empty == "tail":
        pos[:, 80:] = -1
    else:
        pos[1] = -1
    k[:, pos < 0] = float("nan")
    v[:, pos < 0] = float("nan")
    args = (q, k.to(dtype), v.to(dtype), pos.to(torch.int32))
    before = decode_kernel.decode_attention.launches
    out = decode_kernel.decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_kernel.decode_attention.launches == before + 1
    want = ref.decode_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 2e-5
    if empty == "empty_row":
        assert out[:, 1].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,rows", [(4, 97, [0, 2]), (8, 2048, [7]),
                                      (3, 33, [0, 1, 2])])
def test_decode_kernel_all_empty_rows_are_zeros(dev, dtype, B, C, rows):
    """Rows whose k_pos are all -1 (NaN in every slot) come out as exact
    zeros, as the reference's Pallas kernel gives them."""
    gen = torch.Generator(device=dev).manual_seed(C + B)
    q = torch.randn((2, B, 16, 64), generator=gen, device=dev)
    k = torch.randn((2, B, C, 16, 64), generator=gen, device=dev)
    v = torch.randn((2, B, C, 16, 64), generator=gen, device=dev)
    pos = torch.arange(C, device=dev).expand(B, C).clone()
    pos[rows] = -1
    k[:, pos < 0] = float("nan")
    v[:, pos < 0] = float("nan")
    args = (q, k.to(dtype), v.to(dtype), pos.to(torch.int32))
    out = decode_kernel.decode_attention(*args)
    torch.cuda.synchronize()
    want = ref.decode_attention(*args)
    assert torch.isfinite(out).all()
    assert (out[:, rows] == 0).all() and (want[:, rows] == 0).all()
    assert (out - want).abs().max().item() < 2e-5


def test_attention_kernels_refuse_bad_inputs(dev):
    q = torch.randn(2, 1, 8, 4, 16, device=dev)
    k = torch.randn(2, 1, 8, 2, 16, device=dev)
    cache = torch.randn(2, 1, 8, 2, 16, device=dev)
    pos = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    cases = [
        (flash_kernel.flash_attention, (q, k, k.double())),
        (flash_kernel.flash_attention, (q, k.transpose(2, 3), k)),
        (flash_kernel.flash_attention, (q.cpu(), k.cpu(), k.cpu())),
        (decode_kernel.decode_attention, (q[:, :, 0], cache, cache,
                                          pos.long())),
        (decode_kernel.decode_attention, (q[:, :, 0], cache,
                                          cache[:, :, :4], pos)),
        (window_kernel.paged_decode_window_attention,
         (q, cache, cache, torch.zeros(1, 2, dtype=torch.int32, device=dev),
          torch.zeros(1, dtype=torch.int64, device=dev))),
    ]
    for fn, args in cases:
        before = fn.launches
        with pytest.raises(ValueError):
            fn(*args)
        assert fn.launches == before


def _lm_pds(dev, cfg, n=2):
    """The same random particles on the card and on the CPU."""
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    gpu_pd = PushDistribution(module, seed=0, device=dev)
    cpu_pd = PushDistribution(module, device="cpu")
    for _ in range(n):
        pid = gpu_pd.p_create()
        cpu_pd.p_create(params=tree_map(lambda a: a.cpu(),
                                        gpu_pd.p_params(pid)))
    return gpu_pd, cpu_pd


def test_speculative_serve_decode_kernels_match_plain(dev):
    """Speculative serve_decode on the card (window, paged and prefill
    kernels) against the same weights on the CPU (plain versions)."""
    cfg = configs.get("qwen1.5-0.5b").replace(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 512, int(rng.integers(3, 20))))
               for _ in range(5)]
    outs = []
    for pd in _lm_pds(dev, cfg):
        svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=3,
                           speculative=3)
        counts = (window_kernel.paged_decode_window_attention.launches,
                  flash_kernel.flash_attention.launches)
        try:
            gens = [h.result(120) for h in
                    [svc.generate_async(p, max_new=8) for p in prompts]]
            st = svc.stats()
        finally:
            svc.close()
        got = (window_kernel.paged_decode_window_attention.launches
               - counts[0], flash_kernel.flash_attention.launches - counts[1])
        if pd.device.type == "cuda":
            assert got == (cfg.n_layers * st["speculative"]["verify_calls"],
                           cfg.n_layers * st["prefills"])
        else:
            assert got == (0, 0)
        assert st["pool"]["used_pages"] == 0
        outs.append(gens)
    for a, b in zip(*outs):
        assert a.tokens == b.tokens
        assert np.allclose(a.entropy, b.entropy, atol=1e-4)
        assert np.allclose(a.mutual_info, b.mutual_info, atol=1e-4)


def test_stateful_dense_decode_kernels_match_plain(dev):
    """PredictiveEngine(stateful=True) over api.prefill / api.decode_step
    on the card (prefill and dense decode kernels) against the CPU."""
    cfg = configs.get("qwen1.5-0.5b").replace(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, 512, (3, 12))
    outs = []
    for pd in _lm_pds(dev, cfg):
        eng = PredictiveEngine(
            lambda p, c, b: api.decode_step(p, b["token"], c, b["cur_pos"],
                                            cfg),
            store=pd.store, stateful=True)
        toks = torch.as_tensor(prompts, device=pd.device)
        before = decode_kernel.decode_attention.launches
        state = eng.init_state(lambda p: api.prefill(
            p, {"tokens": toks[:, :-1]}, cfg, max_len=12 + 6)[1])
        tok, seq = toks[:, -1], []
        for step in range(6):
            heads, state = eng.step(state, {"token": tok,
                                            "cur_pos": 11 + step})
            tok = heads["mean"].argmax(-1)
            seq.append(tok.cpu().numpy())
        launches = decode_kernel.decode_attention.launches - before
        assert launches == (6 * cfg.n_layers if pd.device.type == "cuda"
                            else 0)
        outs.append(np.stack(seq, 1))
    assert np.array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# step capture: each serving step captured once as a CUDA graph
# ---------------------------------------------------------------------------

def _capture_cfg():
    return configs.get("qwen1.5-0.5b").replace(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128)


def _host(tree):
    return tree_map(lambda a: a.to("cpu", copy=True)
                    if isinstance(a, torch.Tensor) else a, tree)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _step_cases(cfg, pd, dev):
    """(name, spec, a maker of its in-place tree, [args for each call]) of
    each serving step: paged decode, prefill (bucket 16), the draft at 2
    iterations, the verify window, the stateful dense-cache step."""
    from repro_torch.runtime import specs
    from repro_torch.serve import uncertainty
    from repro_torch.serve.engine import sample_heads
    params, mask = pd.store.stacked("params"), pd.store.active_mask()
    n_pmax = 6

    def decode_fn(p, pg, tokens, bt, sl):
        return api.decode_step_paged(p, tokens, pg, bt, sl, cfg)

    def prefill_fn(p, pg, tokens, bt_row, n):
        return api.prefill_paged(p, tokens, pg, bt_row, n, cfg)

    def verify_fn(p, pg, tokens, bt, sl, wl):
        return api.decode_window_paged(p, tokens, pg, bt, sl, wl, cfg)

    def pool():
        shapes = api.paged_cache_init(cfg, num_pages=17, page_size=8,
                                      device="meta")
        gen = torch.Generator(device=dev).manual_seed(0)
        return tree_map(lambda s: torch.randn((2,) + tuple(s.shape),
                                              generator=gen, device=dev),
                        shapes)

    bt = np.zeros((3, n_pmax), np.int32)
    bt[0, :3], bt[2, :2] = [2, 3, 4], [9, 10]

    def rows(head):
        return np.concatenate([np.asarray(head, np.int32), bt], 1)

    def prefill(n):
        buf = np.zeros(16 + n_pmax + 1, np.int32)
        buf[:n] = np.arange(3, 3 + n)
        buf[16:16 + n_pmax] = [11, 12, 0, 0, 0, 0]
        buf[-1] = n
        return buf

    yield ("decode", specs.paged_decode_step(decode_fn, sample_heads), pool,
           [(rows([[5, 13], [0, -1], [7, 9]]), mask),
            (rows([[8, 14], [3, 2], [1, 10]]), mask),
            (rows([[9, 15], [0, -1], [0, -1]]), mask)])
    yield ("prefill", specs.paged_prefill(prefill_fn, sample_heads,
                                          n_pmax=n_pmax), pool,
           [(prefill(n), mask) for n in (11, 16, 1)])
    yield ("draft", specs.spec_draft_step(decode_fn, slot=1, n_iter=2), pool,
           [(rows([[5, 13, 2], [0, -1, 0], [7, 9, 1]]),),
            (rows([[6, 15, 1], [4, 3, 2], [7, 10, 2]]),)])
    yield ("verify", specs.spec_verify(verify_fn, sample_heads, w_max=3),
           pool,
           [(rows([[5, 6, 7, 13, 3], [0, 0, 0, -1, 0], [7, 1, 0, 9, 2]]),
             mask),
            (rows([[1, 2, 3, 14, 2], [0, 0, 0, -1, 0], [3, 4, 5, 10, 3]]),
             mask)])
    toks = torch.as_tensor(np.arange(24).reshape(3, 8) % 500 + 1,
                           device=dev, dtype=torch.int32)

    def caches():
        return api.prefill(params, {"tokens": toks}, cfg, max_len=12)[1]

    def forward(p, c, batch):
        return api.decode_step(p, batch["token"], c, batch["cur_pos"], cfg)

    yield ("dense", specs.bma_step(
        forward, lambda o, m: uncertainty.predictive_heads(o, "classify", m)),
        caches, [({"token": toks[:, j], "cur_pos": 8 + j}, mask)
                 for j in range(3)])


def test_captured_steps_replay_the_eager_bits(dev):
    """Each serving step captured as a CUDA graph (first call: capture,
    then replays on new inputs) gives the same bits as the eager step on
    the same inputs, outputs and in-place trees alike, and launches each
    kernel once per call. Each call's outputs are its own: they are read
    only after the later calls have replayed."""
    from repro_torch.kernels.ops import COUNTED
    from repro_torch.runtime import ProgramCache, eager, lower
    cfg = _capture_cfg()
    pd, _ = _lm_pds(dev, cfg)
    params = pd.store.stacked("params")
    for name, spec, make, calls in _step_cases(cfg, pd, dev):
        got = {}
        for mode, capturer in (("graph", lower), ("eager", eager)):
            cache = ProgramCache(capturer=capturer)
            tree = make()
            before = [k.launches for k in COUNTED]
            outs = []
            for rest in calls:
                out = cache.run(spec, params, tree, *rest)
                outs.append(out[0])
            torch.cuda.synchronize()
            got[mode] = ([_host(o) for o in outs], _host(tree),
                         [k.launches - b for k, b in zip(COUNTED, before)])
            assert cache.snapshot_stats()["cold_compiles"] == 1
            assert (cache.program_costs()[0]["graph"]) == (mode == "graph")
        assert _same_bits(got["graph"][0], got["eager"][0]), name
        assert _same_bits(got["graph"][1], got["eager"][1]), name
        assert got["graph"][2] == got["eager"][2], name
        assert sum(got["eager"][2]) > 0, name


def test_captured_dense_step_raises_outside_the_cache(dev):
    """A captured dense-cache step checks cur_pos on the host: at the
    cache length it raises ValueError, on the capturing call and on a
    replay, before anything runs on the card; the engine then goes on
    stepping, and its heads are the eager engine's bit for bit."""
    from repro_torch.runtime import ProgramCache, eager
    cfg = _capture_cfg()
    pd, _ = _lm_pds(dev, cfg)
    toks = torch.as_tensor(np.arange(24).reshape(3, 8) % 500 + 1,
                           device=dev, dtype=torch.int32)
    C = 12

    def forward(p, c, batch):
        return api.decode_step(p, batch["token"], c, batch["cur_pos"], cfg)

    def run(cache):
        engine = PredictiveEngine(forward, store=pd.store, stateful=True,
                                  cache=cache)
        state = engine.init_state(lambda p: api.prefill(
            p, {"tokens": toks}, cfg, max_len=C)[1])
        with pytest.raises(ValueError, match="outside"):
            engine.step(state, {"token": toks[:, 0], "cur_pos": C})
        heads = []
        for j in range(3):
            heads.append(engine.step(state, {"token": toks[:, j],
                                             "cur_pos": 8 + j})[0])
            with pytest.raises(ValueError, match="outside"):
                engine.step(state, {"token": toks[:, j], "cur_pos": C})
        torch.cuda.synchronize()
        return [_host(h) for h in heads], _host(state), cache, state

    # the cache keeps the program while its dense caches live (``live``)
    graph, graph_state, cache, live = run(ProgramCache())
    assert cache.program_costs()[0]["graph"]
    assert cache.snapshot_stats()["cold_compiles"] == 1
    del live
    plain, plain_state, _, _ = run(ProgramCache(capturer=eager))
    assert _same_bits(graph, plain) and _same_bits(graph_state, plain_state)


def _serve(pd, cfg, cache, prompts, **kw):
    svc = serve_decode(pd, cfg, num_pages=12, page_size=4, max_active=3,
                       warmup_buckets=(8, 16, 32), cache=cache, **kw)
    try:
        cold = svc.stats()["cold_compiles"]
        gens = [h.result(300) for h in
                [svc.generate_async(p, max_new=8) for p in prompts]]
        st = svc.stats()
    finally:
        svc.close()
    return gens, st, cold


@pytest.mark.parametrize("speculative", [None, 2])
def test_no_capture_after_warmup_on_the_card(dev, speculative):
    """Admission, retirement and preemption after warmup capture nothing,
    and the captured service emits the eager service's tokens bit for bit
    (logprobs, entropy and mutual information exactly)."""
    from repro_torch.runtime import ProgramCache, eager
    cfg = _capture_cfg()
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 500, n)) for n in (9, 13, 11, 12, 7)]
    pd, _ = _lm_pds(dev, cfg)
    cache = ProgramCache()
    graph, st, cold = _serve(pd, cfg, cache, prompts,
                             speculative=speculative)
    assert st["preempted"] >= 1 and st["retired"] == len(prompts)
    assert st["cold_compiles"] == cold > 0
    assert all(p["graph"] for p in cache.program_costs())
    plain, _, _ = _serve(pd, cfg, ProgramCache(capturer=eager), prompts,
                         speculative=speculative)
    for a, b in zip(graph, plain):
        assert a.tokens == b.tokens
        assert a.logprobs == b.logprobs and a.entropy == b.entropy
        assert a.mutual_info == b.mutual_info


def test_params_commit_recaptures_on_the_card(dev):
    """A training commit replaces the stacked params: the next step misses
    and captures again, and its tokens are the new params' (an eager run
    over the same new params), not a stale replay of the old tensors."""
    from repro_torch.runtime import ProgramCache, eager
    cfg = _capture_cfg()
    pd, _ = _lm_pds(dev, cfg)
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    cache = ProgramCache()
    first, _, _ = _serve(pd, cfg, cache, prompts)
    cold = cache.snapshot_stats()["cold_compiles"]
    gen = torch.Generator(device=dev).manual_seed(9)
    pd.store.commit("params", tree_map(
        lambda a: a + 0.05 * torch.randn(a.shape, generator=gen, device=dev),
        pd.store.stacked("params")))
    torch.cuda.empty_cache()
    after, st, _ = _serve(pd, cfg, cache, prompts)
    assert cache.snapshot_stats()["cold_compiles"] > cold
    want, _, _ = _serve(pd, cfg, ProgramCache(capturer=eager), prompts)
    for a, b, c in zip(after, want, first):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs
        assert a.logprobs != c.logprobs


def test_launch_counters_match_the_profiler_through_replays(dev):
    """Replays add their recorded launches to the kernels' counters: over
    a profiled window of replayed decode steps and prefills, each counter
    moves by the number of its kernel's launches the profiler sees."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import ProgramCache
    cfg = _capture_cfg()
    pd, _ = _lm_pds(dev, cfg)
    svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=3,
                       warmup_buckets=(16,), cache=ProgramCache())
    try:
        eng, sched = svc.engine, svc.scheduler
        packed = sched._packed
        packed[:] = 0
        packed[:, 1] = -1
        packed[0, :3] = [5, 3, 1]
        buf = sched._prefill_buf(16)
        buf[:] = 0
        buf[:5], buf[16], buf[-1] = [1, 2, 3, 4, 5], 1, 5
        eng.decode_step(packed)
        eng.prefill(buf)
        torch.cuda.synchronize()
        counts = (kernel.paged_decode_attention.launches,
                  flash_kernel.flash_attention.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.decode_step(packed)
                eng.prefill(buf)
            torch.cuda.synchronize()
        moved = (kernel.paged_decode_attention.launches - counts[0],
                 flash_kernel.flash_attention.launches - counts[1])
        assert svc.stats()["cold_compiles"] == 2
    finally:
        svc.close()
    seen = {"split_kernel<": 0, "flash_kernel<": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in seen:
            if name in e.key:
                seen[name] += e.count
    assert moved == (3 * cfg.n_layers, 3 * cfg.n_layers)
    assert (seen["split_kernel<"], seen["flash_kernel<"]) == moved


# --------------------------------------------------------------------------
# train-step capture: the fused DeepEnsemble, SteinVGD and MultiSWAG steps,
# the SWAG collection and p_predict as captured programs
# --------------------------------------------------------------------------

TRAIN_CAPTURE = {
    "ensemble": (lambda: {"optimizer": sgd(0.05)}, ("params", "opt_state"),
                 ["ensemble_step"]),
    "svgd-ell1": (lambda: {"lr": 0.05, "lengthscale": 1.0}, ("params",),
                  ["svgd_step"]),
    "svgd-median": (lambda: {"lr": 0.05, "lengthscale": 0.0}, ("params",),
                    ["svgd_step"]),
    "multiswag": (lambda: {"optimizer": adam(1e-3), "pretrain_epochs": 1,
                           "max_rank": 3},
                  ("params", "opt_state", "swag"),
                  ["ensemble_step", "map_step"]),
}


def _train_capture_run(dev, name, capturer):
    """6 particles in a store of capacity 8 (2 dead slots) trained for 3
    epochs of 2 batches through a ProgramCache with ``capturer``; returns
    the state, losses, kernel launches, cache stats and program info,
    and one p_predict."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.runtime import ProgramCache
    cls = {"ensemble": DeepEnsemble, "multiswag": MultiSWAG}.get(
        name, SteinVGD)
    kw, keys, _ = TRAIN_CAPTURE[name]
    cfg, (mod, _) = _vit_modules(dev, 6)
    algo = cls(mod, backend="compiled", capacity=8, device=dev)
    cache = ProgramCache(capturer=capturer)
    algo.push_dist.runtime.cache = cache
    counters = (svgd_rbf.pairwise_sqdist, svgd_rbf.svgd_force,
                swag_moments.moments_leaves)
    before = [k.launches for k in counters]
    _, losses = algo.bayes_infer(DataLoader(cfg, batch_size=8,
                                            num_batches=2), 3,
                                 num_particles=6, **kw())
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(counters, before)]
    stats, info = cache.snapshot_stats(), cache.program_costs()
    state = [_host(algo.store.stacked(k)) for k in keys]
    batch = next(iter(DataLoader(cfg, batch_size=6, num_batches=1, seed=1)))
    pred = algo.posterior_pred(batch).cpu()
    return state, losses, launches, stats, info, pred


@pytest.mark.parametrize("name", sorted(TRAIN_CAPTURE))
def test_captured_training_matches_eager(dev, name):
    """The fused run with every step (and collection) captured once as a
    CUDA graph and replayed gives the eager run's params, optimizer
    state, SWAG moments and ring, losses and p_predict bit for bit, with
    the same kernel launches; each spec is captured once, at the first
    step, and nothing after it."""
    from repro_torch.runtime import eager, lower
    names = TRAIN_CAPTURE[name][2]
    got = {mode: _train_capture_run(dev, name, capturer)
           for mode, capturer in (("graph", lower), ("eager", eager))}
    g, e = got["graph"], got["eager"]
    assert _same_bits(g[0], e[0])
    assert g[1] == e[1]
    assert g[2] == e[2]
    if name != "ensemble":
        assert sum(g[2]) > 0
    for stats, info, graph in ((g[3], g[4], True), (e[3], e[4], False)):
        assert sorted(p["name"] for p in info) == sorted(names)
        assert stats["misses"] == stats["cold_compiles"] == len(names)
        assert all(p["graph"] == graph for p in info)
    assert torch.equal(g[5], e[5])


# --------------------------------------------------------------------------
# the actor runtime on the card: NEL SteinVGD and MultiSWAG against the
# compiled path, a nested send-and-wait on the one device worker
# --------------------------------------------------------------------------

def _bounded(fn, *args, timeout=300.0, **kw):
    """``fn(*args, **kw)`` on a thread joined within ``timeout`` s: a
    deadlocked protocol fails the test instead of hanging it."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:      # handed to the test below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not finish within {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _nel_and_compiled(dev, cls, **kw):
    """The same 4 particles trained 3 epochs of 2 batches under each
    backend on the card; returns {backend: (algo, pids, launches)}, the
    launches of sqdist, force and moments over the run."""
    cfg, mods = _vit_modules(dev, 4)
    counters = (svgd_rbf.pairwise_sqdist, svgd_rbf.svgd_force,
                swag_moments.moments_leaves)
    out = {}
    for backend, mod in zip(("nel", "compiled"), mods):
        algo = cls(mod, backend=backend, device=dev)
        before = [k.launches for k in counters]
        pids, _ = _bounded(algo.bayes_infer,
                           DataLoader(cfg, batch_size=8, num_batches=2), 3,
                           num_particles=4, **kw)
        torch.cuda.synchronize()
        out[backend] = (algo, pids, [k.launches - b for k, b in
                                     zip(counters, before)])
    return cfg, out


def test_nel_svgd_on_card_matches_compiled(dev):
    cfg, out = _nel_and_compiled(dev, SteinVGD, lr=0.05, lengthscale=0.0)
    (nel, _, nl), (comp, _, cl) = out["nel"], out["compiled"]
    try:
        assert nl == [6, 6, 0] and cl == [6, 6, 0]     # one each a step
        _close(nel.p_parameters(), comp.p_parameters(), 1e-4)
        batch = next(iter(DataLoader(cfg, batch_size=6, num_batches=1,
                                     seed=1)))
        got = _bounded(nel.posterior_pred, batch)
        _close([got], [comp.posterior_pred(batch)], 1e-4)
    finally:
        nel.cleanup()
        comp.cleanup()


def test_nel_multiswag_on_card_matches_compiled(dev):
    cfg, out = _nel_and_compiled(dev, MultiSWAG, optimizer=adam(1e-3),
                                 pretrain_epochs=1, max_rank=3)
    (nel, npids, nl), (comp, cpids, cl) = out["nel"], out["compiled"]
    try:
        assert nl == [0, 0, 2 * 4]     # P = 1 views: one a particle
        assert cl == [0, 0, 2]         # one a collection
        _close(nel.p_parameters(), comp.p_parameters(), 1e-4)
        for a, b in zip(npids, cpids):
            sa = nel.push_dist.particles[a].state["swag"]
            sb = comp.push_dist.particles[b].state["swag"]
            assert int(sa["rank"]) == int(sb["rank"]) == 2
            _close([sa["mean"], sa["sq_mean"], sa["dev"]],
                   [sb["mean"], sb["sq_mean"], sb["dev"]], 1e-4)
    finally:
        nel.cleanup()
        comp.cleanup()


def test_nested_send_and_wait_on_one_device_worker(dev):
    """On one device worker, a handler that sends to another particle and
    waits on it finishes: the worker runs the queued message inline (the
    context switch on wait). Both ran on that worker, the card current."""
    def init(gen):
        return {"w": torch.randn((64, 64), generator=gen, device=gen.device)}

    def inner(p):
        w = p.parameters()["w"]
        return (threading.current_thread().name,
                torch.cuda.current_device(), float((w @ w).sum()))

    def outer(p, other):
        name = threading.current_thread().name
        return name, p.send(other, "INNER").wait(30)

    with PushDistribution(ParticleModule(init), device=dev) as pd:
        a = pd.p_create(receive={"OUTER": outer})
        b = pd.p_create(receive={"INNER": inner})
        name, (inner_name, cur, val) = _bounded(
            lambda: pd.p_launch(a, "OUTER", b).wait(30))
        w = pd.p_params(b)["w"]
        assert name == inner_name == "push-dev0"
        assert cur == 0                     # the NEL's device, cuda:0
        assert abs(val - float((w @ w).sum())) <= 1e-3 * abs(val) + 1e-3
        st = pd.stats()["executor"]
        assert st["dispatched"] == st["completed"] == 2
        assert st["threads"] == pd.nel.executor.num_threads


# --------------------------------------------------------------------------
# the particle lifecycle on the card: clone / kill within capacity keep
# every stacked tensor at its address, so nothing is captured again
# --------------------------------------------------------------------------

def _churn_pd(dev, cfg, n=2):
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    pd = PushDistribution(module, seed=0, capacity=4, device=dev)
    for _ in range(n):
        pd.p_create()
    return pd


def _ptrs(store, key):
    return [x.data_ptr() for x in tree_leaves(store.stacked(key))]


@pytest.mark.parametrize("speculative", [None, 2])
def test_clone_within_capacity_keeps_addresses_and_captures_nothing(
        dev, speculative):
    """A jittered clone under ``step_lock`` writes into the params' and the
    page pool's stacked tensors in place: no address moves, no step is
    captured again, ``generation()`` holds; after the twin's kill the
    captured service emits its pre-churn tokens and logprobs exactly."""
    from repro_torch.runtime import ProgramCache
    cfg = _capture_cfg()
    pd = _churn_pd(dev, cfg)
    prompts = [[5, 6, 7, 8, 9], [9, 10, 11]]
    cache = ProgramCache()
    svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=2,
                       warmup_buckets=(4, 8), speculative=speculative,
                       cache=cache)
    try:
        base = [svc.generate(p, max_new=6) for p in prompts]
        cold, gen = svc.stats()["cold_compiles"], pd.store.generation()
        with svc.scheduler.step_lock:
            ptrs = {k: _ptrs(pd.store, k) for k in ("params", "kv_pages")}
            twin = pd.p_clone(0, jitter=0.01)
            assert {k: _ptrs(pd.store, k) for k in ptrs} == ptrs
        wide = [svc.generate(p, max_new=6) for p in prompts]
        with svc.scheduler.step_lock:
            pd.p_kill(twin)
        back = [svc.generate(p, max_new=6) for p in prompts]
        st = svc.stats()
        assert all(p["graph"] for p in cache.program_costs())
    finally:
        svc.close()
    assert st["cold_compiles"] == cold and pd.store.generation() == gen
    assert st["pool"]["used_pages"] == 0
    assert all(len(w.tokens) == 6 for w in wide)
    for a, b in zip(base, back):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs


def test_killing_the_drafter_repicks_without_a_capture(dev):
    """Warmup captures the draft at every slot of the capacity: killing
    the drafting particle switches the draft to the next live slot's
    program (``slot_uploads``) without a capture, and the one remaining
    particle's tokens equal an eager plain service's over it."""
    from repro_torch.runtime import ProgramCache, eager
    cfg = _capture_cfg()
    pd = _churn_pd(dev, cfg)
    prompt = [5, 6, 7, 8, 9, 10, 11]
    cache = ProgramCache()
    svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=2,
                       warmup_buckets=(8,), speculative=2, cache=cache)
    try:
        drafts = [p for p in cache.program_costs()
                  if p["name"] == "spec_draft_step"]
        assert len(drafts) == 2 * pd.store.capacity
        svc.generate(prompt, max_new=6)
        st = svc.stats()
        cold, uploads = st["cold_compiles"], st["engine"]["slot_uploads"]
        with svc.scheduler.step_lock:
            pd.p_kill(0)
        solo = svc.generate(prompt, max_new=6)
        st = svc.stats()
    finally:
        svc.close()
    assert st["cold_compiles"] == cold
    assert st["engine"]["slot_uploads"] == uploads + 1
    plain = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=2,
                         warmup=False, cache=ProgramCache(capturer=eager))
    try:
        want = plain.generate(prompt, max_new=6)
    finally:
        plain.close()
    assert solo.tokens == want.tokens


@pytest.mark.parametrize("name", ["svgd", "multiswag"])
def test_fused_training_after_churn_on_the_card(dev, name):
    """8 particles in a store of capacity 8: after two kills and one
    jittered clone (7 live, slot 5 dead) the captured fused run reuses
    its programs, leaves the dead slot's params, optimizer state and SWAG
    state bit for bit and reports loss 0 there; the kernels #1-#4 at the
    churned state, dead row and all, match their plain versions."""
    from repro_torch.core.functional import flatten_stacked
    from repro_torch.runtime import ProgramCache
    cfg, (mod, _) = _vit_modules(dev, 8)
    cls = SteinVGD if name == "svgd" else MultiSWAG
    kw = ({"lr": 0.05, "lengthscale": 0.0} if name == "svgd" else
          {"optimizer": adam(1e-3), "max_rank": 3})
    algo = cls(mod, backend="compiled", capacity=8, device=dev)
    pd, cache = algo.push_dist, ProgramCache()
    pd.runtime.cache = cache
    data = DataLoader(cfg, batch_size=8, num_batches=2)
    pids, _ = algo.bayes_infer(data, 2, num_particles=8, **kw)
    pd.p_kill(pids[1])
    pd.p_kill(pids[5])
    clone = pd.p_clone(pids[0], jitter=0.01)
    assert pd.store.slot_of(clone) == 1 and pd.store.live_count() == 7
    keys = pd.store.keys()
    dead = {k: _host(tree_map(lambda a: a[5], pd.store.stacked(k)))
            for k in keys if k != "grads"}
    misses = cache.snapshot_stats()["misses"]
    kw.pop("max_rank", None)
    losses = algo._fused_epochs(pd.particle_ids(), data, 2, **kw)
    torch.cuda.synchronize()
    assert cache.snapshot_stats()["misses"] == misses
    assert len(losses) == 7 and np.isfinite(losses).all()
    for k, row in dead.items():
        assert _same_bits(_host(tree_map(lambda a: a[5],
                                         pd.store.stacked(k))), row)
    mask = pd.store.active_mask()
    assert mask.tolist() == [1, 1, 1, 1, 1, 0, 1, 1]
    theta, _ = flatten_stacked(pd.store.stacked("params"))
    got = svgd_rbf.pairwise_sqdist(theta, mask)
    assert (got - ref.pairwise_sqdist(theta, mask)).abs().max().item() \
        < 1e-5 * got.max().item()
    g = torch.randn(theta.shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    phi = bsvgd.svgd_force(theta, g, 0.0, mask=mask)
    want = _plain_force(theta, g, 0.0, mask)
    assert (phi - want).abs().max().item() < 2e-4 * want.abs().max().item()
    assert phi[5].abs().max().item() == 0.0
    if name == "multiswag":
        swag = pd.store.stacked("swag")
        m0, s0 = flatten_stacked(swag["mean"])[0], \
            flatten_stacked(swag["sq_mean"])[0]
        mk, sk = swag_moments.moments(m0, s0, theta, swag["n"], mask)
        mp, sp = ref.swag_moments(m0, s0, theta, swag["n"], mask)
        assert (mk - mp).abs().max().item() < 1e-5
        assert (sk - sp).abs().max().item() < 1e-5
        assert torch.equal(mk[5], m0[5]) and torch.equal(sk[5], s0[5])
        live = mask > 0
        got = swag_moments.diag_std(mk[live].contiguous(),
                                    sk[live].contiguous())
        want = ref.diag_std(mp[live].contiguous(), sp[live].contiguous())
        assert (got - want).abs().max().item() < 1e-5


# --------------------------------------------------------------------------
# classification serving: the BMA predict captured per bucket, the
# micro-batcher's pinned staging
# --------------------------------------------------------------------------

def _vit_pd(dev, P, capacity=0):
    cfg, (mod, _) = _vit_modules(dev, P)
    pd = PushDistribution(mod, capacity=capacity, device=dev)
    for _ in range(P):
        pd.p_create()
    return cfg, pd


def _requests(cfg, n, seed=3):
    from repro_torch.data import mnist_like
    images = mnist_like(np.random.default_rng(seed), n,
                        cfg.vocab_size)["images"]
    return images, [{"images": im} for im in images]


def test_predict_captures_each_bucket_once_and_replays_eager_bits(dev):
    """Buckets 1-8: the first call of each captures, later calls replay
    on new rows, and every result equals an eager engine's bits."""
    from repro_torch.runtime import ProgramCache, eager
    cfg, pd = _vit_pd(dev, 4)
    fwd = pd.module.forward
    graph = PredictiveEngine(fwd, store=pd.store)
    plain = PredictiveEngine(fwd, store=pd.store,
                             cache=ProgramCache(capturer=eager))
    from repro_torch.runtime.program import h2d_copies
    images, _ = _requests(cfg, 16)
    copies = {"graph": 0, "eager": 0}
    for m in (1, 2, 3, 4, 8, 5):
        for lo in (0, 8):
            batch = {"images": images[lo:lo + m]}
            c0 = h2d_copies()
            got = graph.predict(batch)
            c1 = h2d_copies()
            want = plain.predict(batch)
            copies["graph"] += c1 - c0
            copies["eager"] += h2d_copies() - c1
            for k in want:
                assert torch.equal(got[k], want[k]), (m, k)
    st = graph.snapshot_stats()
    assert st["compiles"] == 4 and st["bucket_hits"] == 8
    assert all(p["graph"] for p in graph.cache.program_costs())
    assert not any(p["graph"] for p in plain.cache.program_costs())
    # one host-to-device copy per call (one leaf), graph and eager alike
    assert copies == {"graph": 12, "eager": 12}
    graph.close()
    assert len(graph.cache) == 0
    pd.cleanup()


def test_predict_async_under_threads_equals_predict_batch(dev):
    cfg, pd = _vit_pd(dev, 4)
    images, reqs = _requests(cfg, 64)
    with serve(pd, max_batch=8, max_wait_ms=2.0, warmup=reqs[0]) as svc:
        warm = svc.engine.cache.snapshot_stats()
        assert warm["cold_compiles"] == 4          # buckets 1, 2, 4, 8
        out = {}

        def client(c):
            hs = [(i, svc.predict_async(reqs[i]))
                  for i in range(c, 64, 8)]
            for i, h in hs:
                out[i] = h.result(60.0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        want = svc.predict_batch({"images": images[:8]})
        st = svc.stats()
        assert st["errors"] == 0 and st["queue_depth"] == 0
        assert st["requests"] == 64
        assert svc.engine.cache.snapshot_stats()["cold_compiles"] == \
            warm["cold_compiles"]
        for i in range(8):
            assert abs(out[i].mean - want["mean"][i].cpu().numpy()
                       ).max() < 1e-5
        rest = svc.predict_batch({"images": images[8:64]})   # bucket 64
        for i in range(8, 64):
            for k in ("mean", "entropy", "mutual_info", "variance",
                      "expected_entropy"):
                assert abs(getattr(out[i], k) - rest[k][i - 8].cpu().numpy()
                           ).max() < 1e-5, (i, k)
    pd.cleanup()


def test_no_capture_after_a_kill_on_the_card(dev):
    cfg, pd = _vit_pd(dev, 4, capacity=4)
    images, reqs = _requests(cfg, 8)
    with serve(pd, max_batch=8, max_wait_ms=1.0, warmup=reqs[0]) as svc:
        cold = svc.engine.cache.snapshot_stats()["cold_compiles"]
        gen = pd.store.generation()
        before = [h.result(60.0) for h in
                  [svc.predict_async(r) for r in reqs]]
        pd.p_kill(pd.particle_ids()[2])
        after = [h.result(60.0) for h in
                 [svc.predict_async(r) for r in reqs]]
        assert svc.engine.cache.snapshot_stats()["cold_compiles"] == cold
        assert pd.store.generation() == gen
        # the live members' outputs (a spec of its own: one capture)
        heads, outs = svc.predict_batch({"images": images}, members=True)
        assert outs.shape[0] == 3
        bma = torch.softmax(outs.float(), -1).mean(0)
        assert (heads["mean"] - bma).abs().max().item() < 1e-5
        for i, p in enumerate(after):
            assert abs(p.mean - bma[i].cpu().numpy()).max() < 1e-5
        assert max(abs(a.mean - b.mean).max()
                   for a, b in zip(after, before)) > 1e-6
    pd.cleanup()


def test_pinned_staging_one_copy_per_leaf_per_flush(dev):
    cfg, pd = _vit_pd(dev, 2)
    images, _ = _requests(cfg, 12)
    labels = np.arange(12, dtype=np.int32)
    reqs = [{"images": im, "labels": lab} for im, lab in zip(images, labels)]
    with serve(pd, max_batch=4, max_wait_ms=60_000,
               warmup=reqs[0]) as svc:
        for r in range(3):
            for h in [svc.predict_async(q) for q in reqs[4 * r:4 * r + 4]]:
                h.result(60.0)
        st = svc.stats()
        assert st["batches"] == st["size_flushes"] == 3
        assert st["h2d_transfers"] == 3 * 2
        assert st["staging_builds"] == 1 and st["staging_reuses"] == 2
        bufs = list(svc.batcher._staging._bufs.values())[0]
        assert all(buf.is_pinned() for buf in bufs)
    pd.cleanup()


@pytest.mark.parametrize("P", [1, 8])
def test_diag_std_kernel_at_the_serving_shapes(dev, P):
    """#4 at P = 1 (a particle's scale in ``sample_predict``) and P = 8
    (the dense stack of ``posterior_predictive``), at ViT-MNIST leaf
    widths: one launch over the four leaves, the per-leaf kernel's bits
    and the plain version within 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(P)
    means, sqs = [], []
    for D in (320, 40 * 320, 320 * 1280, 3 * 320 * 320 + 7):
        m = torch.randn((P, D), generator=gen, device=dev) * 0.1
        means.append(m)
        sqs.append(m * m + torch.rand((P, D), generator=gen, device=dev)
                   * 1e-3)
    before = swag_moments.diag_std_leaves.launches
    got = swag_moments.diag_std_leaves(means, sqs)
    assert swag_moments.diag_std_leaves.launches - before == 1
    for g, m, s in zip(got, means, sqs):
        assert torch.equal(g, swag_moments.diag_std(m, s))
        assert (g - ref.diag_std(m, s)).abs().max().item() < 1e-5


# --------------------------------------------------------------------------
# the precision ladder: the serve copy, the int8 packs, mixed training
# --------------------------------------------------------------------------

def _served_ptrs(engine):
    return [x.data_ptr() for x in tree_leaves(engine._mask_and_params()[1])]


def test_serve_copy_and_int8_pack_keep_addresses_across_a_commit(dev):
    """"mixed" speculative serving with the int8 draft: a jittered clone
    under ``step_lock`` rewrites the bf16 serve copy and the draft's pack
    in place (no address moves, nothing captured), and the clone's row in
    the copy is the bf16 cast of its master."""
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import SpecConfig
    cfg = _capture_cfg()
    pd = _churn_pd(dev, cfg)
    prompts = [[5, 6, 7, 8, 9], [9, 10, 11]]
    cache = ProgramCache()
    svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=2,
                       warmup_buckets=(4, 8), precision="mixed", cache=cache,
                       speculative=SpecConfig(k_max=2, quantized=True))
    try:
        eng = svc.engine
        base = [svc.generate(p, max_new=6) for p in prompts]
        cold = svc.stats()["cold_compiles"]
        copy_ptrs = _served_ptrs(eng)
        pack_ptrs = [x.data_ptr() for x in tree_leaves(eng._pack[:2])]
        packs = eng.stats["draft_packs"]
        with svc.scheduler.step_lock:
            twin = pd.p_clone(0, jitter=0.01)
        wide = [svc.generate(p, max_new=6) for p in prompts]
        with svc.scheduler.step_lock:
            served = eng._mask_and_params()[1]
            slot = pd.store.slot_of(twin)
            master = pd.p_params(twin)
            for a, b in zip(tree_leaves(served), tree_leaves(master)):
                assert torch.equal(a[slot], b.to(torch.bfloat16))
            pd.p_kill(twin)
        back = [svc.generate(p, max_new=6) for p in prompts]
        st = svc.stats()
        assert _served_ptrs(eng) == copy_ptrs
        assert [x.data_ptr() for x in tree_leaves(eng._pack[:2])] \
            == pack_ptrs
        assert eng.stats["draft_packs"] > packs
        assert all(p["graph"] for p in cache.program_costs())
    finally:
        svc.close()
    assert st["cold_compiles"] == cold
    assert all(len(w.tokens) == 6 for w in wide)
    for a, b in zip(base, back):
        assert a.tokens == b.tokens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_pack_on_the_card_equals_the_cpu(dev, dtype):
    """``quantize_int8`` / ``cast_for_serve_into`` on the card give the
    CPU's bits: q and s exactly (round half to even, IEEE division)."""
    from repro_torch.core import precision as prec
    cfg = _capture_cfg()
    gen = torch.Generator().manual_seed(1)
    one = api.init_params(gen, cfg)
    cpu = tree_map(lambda a: torch.stack([a, 3 * a]).to(dtype), one)
    card = tree_map(lambda a: a.to(dev), cpu)
    want = prec.quantize_int8(cpu)
    got = prec.quantize_int8(card)
    _same_bits(_host(got), want)
    copy = prec.serve_copy_like(card, "mixed_int8")
    ptrs = [x.data_ptr() for x in tree_leaves(copy)]
    prec.cast_for_serve_into(copy, card)
    _same_bits(_host(copy), prec.cast_for_serve(cpu, "mixed_int8"))
    assert [x.data_ptr() for x in tree_leaves(copy)] == ptrs


@pytest.mark.parametrize("policy", [None, "mixed"])
def test_quantized_draft_tokens_equal_plain_tokens(dev, policy):
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import SpecConfig
    cfg = _capture_cfg()
    pd = _churn_pd(dev, cfg)
    prompts = [[5, 6, 7, 8, 9], [9, 10, 11], [3, 4]]
    out = []
    for spec in (None, SpecConfig(k_max=3, quantized=True)):
        svc = serve_decode(pd, cfg, num_pages=32, page_size=8, max_active=2,
                           warmup_buckets=(2, 4, 8), precision=policy,
                           speculative=spec, cache=ProgramCache())
        try:
            out.append([svc.generate(p, max_new=8).tokens for p in prompts])
            st = svc.stats()
        finally:
            svc.close()
    assert out[0] == out[1]
    assert st["engine"]["draft_packs"] >= 1
    assert st["pool"]["used_pages"] == 0


def test_mixed_training_keeps_fp32_masters_on_the_card(dev):
    """SteinVGD and DeepEnsemble under "mixed", captured: the masters and
    the optimizer state stay fp32, the losses track the card's fp32 run
    within the reference's bar, one program per spec."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.runtime import ProgramCache
    losses = {}
    for name in ("fp32", "mixed"):
        for cls, kw in ((SteinVGD, {"lr": 0.05}),
                        (DeepEnsemble, {"optimizer": adam(1e-3)})):
            cfg, (mod, _) = _vit_modules(dev, 4)
            loader = DataLoader(cfg, batch_size=8, num_batches=2, seed=0)
            with cls(mod, backend="compiled", precision=name,
                     device=dev) as algo:
                algo.push_dist.runtime.cache = cache = ProgramCache()
                _, ls = algo.bayes_infer(loader, 2, num_particles=4, **kw)
                for leaf in tree_leaves(algo.store.stacked("params")):
                    assert leaf.dtype == torch.float32
                if cls is DeepEnsemble:
                    st = algo.store.stacked("opt_state")
                    assert st["m"]["head"]["w"].dtype == torch.float32
                info = cache.program_costs()
                assert len(info) == 1 and info[0]["graph"]
            losses[name, cls.__name__] = np.asarray(ls)
    for cls in ("SteinVGD", "DeepEnsemble"):
        f32, mixed = losses["fp32", cls], losses["mixed", cls]
        assert np.all(np.abs(mixed - f32) < 0.1 * np.abs(f32) + 0.05), cls


# ---------------------------------------------------------------------------
# the SciML workload: the UNet, its baselines and its regression serving
# ---------------------------------------------------------------------------

def _fp32(dev):
    """Full fp32 products (the reference's): TF32 off for cuBLAS and
    cuDNN, whatever an earlier test left."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _unet_module(cfg):
    return ParticleModule(init=lambda g: api.init_params(g, cfg),
                          loss=lambda p, b: api.loss_fn(p, b, cfg),
                          forward=lambda p, b: api.forward(p, b, cfg)[0],
                          cfg=cfg)


def test_unet_forward_and_grads_on_the_card_equal_the_cpu(dev):
    """The full-width UNet (P = 2, B = 4, L = 128) on the card against the
    CPU on the same weights and batch: outputs and loss within 1e-5 of
    the largest, grads within 1e-5 of the largest (another summation
    order in the batched GEMMs, no TF32)."""
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    _fp32(dev)
    cfg = configs.get("unet-advection")
    gen = torch.Generator().manual_seed(0)
    one = [api.init_params(gen, cfg) for _ in range(2)]
    params = tree_map(lambda *xs: torch.stack(xs), *one)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(DataLoader(
        cfg, batch_size=4, num_batches=1, seed=3))).items()}
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda x: x.to(where), params)
        b = {k: v.to(where) for k, v in batch.items()}
        y = api.forward(p, b, cfg)[0]
        loss, grads = ensemble_value_and_grad(
            lambda pp, bb: api.loss_fn(pp, bb, cfg))(p, b)
        out[str(where)] = (y.cpu(), loss.cpu(),
                           flatten_stacked(grads)[0].cpu())
    (y0, l0, g0), (y1, l1, g1) = out["cpu"], out[str(dev)]
    assert y1.shape == (2, 4, 128, 1)
    for a, b in ((y1, y0), (l1, l0), (g1, g0)):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-5


def test_sqdist_and_force_at_the_unet_shape(dev):
    """8 UNet particles x 1,240,065: D is odd, so #1 takes its plain
    loads; within 1e-5 of the largest distance, exactly symmetric with a
    zero diagonal; #2 within 2e-4 relative with the median heuristic."""
    gen = torch.Generator(device=dev).manual_seed(41)
    t = torch.randn((8, 1_240_065), generator=gen, device=dev) * 0.05
    g = torch.randn((8, 1_240_065), generator=gen, device=dev)
    assert svgd_rbf.plan_for(t).path == "plain"
    a = svgd_rbf.pairwise_sqdist(t)
    want = ref.pairwise_sqdist(t)
    torch.cuda.synchronize()
    assert torch.equal(a, a.T) and (a.diagonal() == 0).all()
    assert ((a - want).abs().max() / want.abs().max()).item() < 1e-5
    got = bsvgd.svgd_force(t, g, 0.0)
    glue = bsvgd.rbf_glue(ref.pairwise_sqdist(t), 0.0)
    plain = ref.svgd_force(t, g, *glue)
    assert ((got - plain).abs().max() / plain.abs().max()).item() < 2e-4


@pytest.mark.parametrize("name", ["ensemble", "svgd", "multiswag"])
def test_baselines_on_the_card_equal_the_cpu(dev, name):
    """Each Fig. 4 baseline over 3 NNs of a narrow UNet on the card against
    the same run on the CPU (params within 1e-4; SWAG moments within
    1e-5), every program a graph on the card, one a NN (SVGD: and one
    update)."""
    from repro_torch.bdl import baselines
    from repro_torch.core.functional import flatten_rows
    from repro_torch.runtime.cache import global_cache
    _fp32(dev)
    cfg = configs.get("unet-advection").smoke().replace(max_seq_len=32)
    gen = torch.Generator().manual_seed(4)
    inits = [api.init_params(gen, cfg) for _ in range(3)]
    runs = {}
    for where in ("cpu", dev):
        # the same three NNs on both devices (a card generator draws
        # another stream than the CPU's)
        it = iter(inits)
        module = ParticleModule(
            init=lambda g: tree_map(lambda x: x.to(g.device, copy=True),
                                    next(it)),
            loss=lambda p, b: api.loss_fn(p, b, cfg),
            forward=lambda p, b: api.forward(p, b, cfg)[0], cfg=cfg)
        data = DataLoader(cfg, batch_size=8, num_batches=2, seed=1)
        before = global_cache().snapshot_stats()["cold_compiles"]
        if name == "svgd":
            out = (baselines.svgd_baseline(module, 3, data, 2, lr=0.05,
                                           lengthscale=0.0, device=where),)
        else:
            fn = getattr(baselines, f"{name}_baseline")
            out = fn(module, sgd(0.05), 3, data, 2, device=where)
        runs[str(where)] = out
        if where != "cpu":
            info = [p for p in global_cache().program_costs()
                    if p["name"].startswith("baseline_")]
            assert global_cache().snapshot_stats()["cold_compiles"] \
                - before == {"ensemble": 3, "svgd": 4, "multiswag": 6}[name]
            assert all(p["graph"] for p in info)
    cpu, card = runs["cpu"], runs[str(dev)]
    a, b = flatten_rows(cpu[0])[0], flatten_rows(card[0])[0].cpu()
    assert (a - b).abs().max().item() < 1e-4
    if name == "multiswag":
        for sa, sb in zip(cpu[1], card[1]):
            for key in ("mean", "sq_mean", "dev"):
                x = flatten_rows([sa[key]])[0]
                y = flatten_rows([sb[key]])[0].cpu()
                assert (x - y).abs().max().item() < 1e-5


def test_unet_regress_serving_on_the_card(dev):
    """``serve(kind="regress")`` over 4 narrow UNet particles on the card:
    single-example requests give (L, 1) means and variances equal to
    ``predict_batch``'s rows within 1e-5, every bucket a graph, nothing
    captured after warmup."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.data import advection_batch
    _fp32(dev)
    cfg = configs.get("unet-advection").smoke().replace(max_seq_len=32)
    with DeepEnsemble(_unet_module(cfg), backend="compiled",
                      device=dev) as algo:
        algo.bayes_infer(DataLoader(cfg, batch_size=8, num_batches=2), 1,
                         optimizer=adam(1e-3), num_particles=4)
        data = advection_batch(np.random.default_rng(2), 12, 32)["u0"]
        reqs = [{"u0": u} for u in data]
        with serve(algo, kind="regress", max_batch=8,
                   warmup=reqs[0]) as svc:
            cache = svc.engine.cache
            info = cache.program_costs()
            assert len(info) == 4 and all(p["graph"] for p in info)
            cold = cache.snapshot_stats()["cold_compiles"]
            preds = [h.result(60.0) for h in
                     [svc.predict_async(r) for r in reqs]]
            assert cache.snapshot_stats()["cold_compiles"] == cold
            heads = svc.predict_batch({"u0": data[:8]})
        for i, p in enumerate(preds[:8]):
            assert p.mean.shape == p.variance.shape == (32, 1)
            for k in ("mean", "variance", "entropy", "mutual_info"):
                assert np.abs(getattr(p, k) - heads[k][i].cpu().numpy()
                              ).max() <= 1e-5


# --------------------------------------------------------------------------
# LM training: a captured DeepEnsemble step of a narrow qwen, the chunked
# attention's backward on the card, a schedule read with no host sync
# --------------------------------------------------------------------------

def _lm_run(dev, capturer):
    """2 narrow-qwen particles, 3 captured (or eager) steps of
    adam(warmup_cosine(3e-3, 2, 4)) over 64-token sequences; the state,
    the losses and the cache's stats and programs."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.optim import warmup_cosine
    from repro_torch.runtime import ProgramCache
    cfg = _capture_cfg()
    mod = ParticleModule(init=lambda g: api.init_params(g, cfg),
                         loss=lambda p, b: api.loss_fn(p, b, cfg), cfg=cfg)
    algo = DeepEnsemble(mod, backend="compiled", device=dev)
    cache = ProgramCache(capturer=capturer)
    algo.push_dist.runtime.cache = cache
    _, losses = algo.bayes_infer(
        DataLoader(cfg, batch_size=2, seq_len=64, num_batches=3), 1,
        num_particles=2, optimizer=adam(warmup_cosine(3e-3, 2, 4)))
    torch.cuda.synchronize()
    out = ([_host(algo.store.stacked(k)) for k in ("params", "opt_state")],
           losses, cache.snapshot_stats(), cache.program_costs())
    algo.cleanup()
    return out


def test_captured_lm_ensemble_step_matches_eager(dev):
    """The LM's DeepEnsemble step captured once as a CUDA graph and
    replayed gives the eager run's params, Adam state and losses bit for
    bit (the embedding's backward accumulates in a sorted order on the
    card), with one program captured at the first step."""
    from repro_torch.runtime import eager, lower
    _fp32(dev)
    g, e = _lm_run(dev, lower), _lm_run(dev, eager)
    assert _same_bits(g[0], e[0]) and g[1] == e[1]
    assert np.isfinite(g[1]).all()
    for (stats, info), graph in (((g[2], g[3]), True), ((e[2], e[3]), False)):
        assert [p["name"] for p in info] == ["ensemble_step"]
        assert stats["misses"] == stats["cold_compiles"] == 1
        assert info[0]["graph"] == graph


def test_chunked_attention_backward_on_the_card(dev):
    """The chunked flash attention's forward and custom backward on the
    card against ``full_attention`` under autograd (700 tokens over
    chunks of 256 and 512, both padded; 2 queries a kv head), within 1e-4
    of each output's largest entry, causal and bidir; and against the
    CPU's chunked run within 1e-5."""
    from repro_torch.models import blocks
    _fp32(dev)
    gen = torch.Generator().manual_seed(3)
    shape = (2, 2, 700)
    q = torch.randn(shape + (4, 64), generator=gen)
    k, v = (torch.randn(shape + (2, 64), generator=gen) for _ in range(2))
    do = torch.randn(shape + (4, 64), generator=gen)

    def fwd_bwd(fn, where):
        args = [x.to(where).requires_grad_(True) for x in (q, k, v)]
        out = fn(*args)
        grads = torch.autograd.grad(out, args, do.to(where))
        return [x.detach().cpu() for x in (out,) + grads]

    for kind in ("causal", "bidir"):
        def flash(a, b, c):
            return blocks.flash_attention(a, b, c, kind=kind, q_chunk=256,
                                          k_chunk=512)

        got = fwd_bwd(flash, dev)
        plain = fwd_bwd(lambda a, b, c: blocks.full_attention(
            a, b, c, causal=kind == "causal"), dev)
        cpu = fwd_bwd(flash, "cpu")
        for a, b, c in zip(got, plain, cpu):
            top = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-4 * top, kind
            assert float((a - c).abs().max()) <= 1e-5 * top, kind


def test_captured_schedule_reads_no_host_sync(dev):
    """Adam under warmup_cosine and Adafactor under cosine on a stacked
    (P,) step: the update runs with no host sync (the dispatch mode of
    tests/test_torch_capture.py refuses ``nonzero``,
    ``_local_scalar_dense`` and ``is_nonzero``), and a CUDA graph of it,
    replayed across the warmup's end, gives the eager updates' bits
    step by step."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.optim import adafactor, cosine, warmup_cosine
    syncs = (torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
             torch.ops.aten.is_nonzero)

    class NoHostSync(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in syncs:
                raise AssertionError(f"host sync in an update: {func}")
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((3, 4, 5), generator=gen),
              "b": torch.randn((3, 5), generator=gen)}
    grads = [tree_map(lambda x: torch.randn(x.shape, generator=gen), params)
             for _ in range(4)]
    for opt in (adam(warmup_cosine(0.1, 2, 4)), adafactor(cosine(0.1, 4))):
        one = opt.init(tree_map(lambda x: x[0], params))
        state = tree_map(lambda x: x.expand((3,) + x.shape).contiguous()
                         .to(dev), one)
        p = tree_map(lambda x: x.to(dev), params)
        want, ps, ss = [], p, state
        for g in grads:
            with NoHostSync():
                ps, ss = opt.update(ps, tree_map(lambda x: x.to(dev), g), ss)
            want.append(_host(ps))
        # the same four steps through one captured update on static tensors
        sp, sst = tree_map(torch.clone, p), tree_map(torch.clone, state)
        sg = tree_map(lambda x: torch.zeros_like(x, device=dev), params)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            opt.update(sp, sg, sst)         # warm-up, off the graph
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            np_, ns = opt.update(sp, sg, sst)
        for g, w in zip(grads, want):
            tree_map(lambda d, x: d.copy_(x), sg, g)
            graph.replay()
            tree_map(lambda d, x: d.copy_(x), sp, np_)
            tree_map(lambda d, x: d.copy_(x), sst, ns)
            assert _same_bits(_host(sp), w)


def test_device_gauges_on_the_card(dev):
    """obs.device_gauges: one "gpu" entry per device, its bytes those of
    the caching allocator and the device's total."""
    from repro_torch.obs import device
    # earlier tests' cyclic garbage, collected between the two reads,
    # would free card memory between them
    gc.collect()
    x = torch.empty((3, 1 << 20), device=dev)
    gauges = device.device_gauges()
    assert len(gauges) == torch.cuda.device_count()
    g = gauges[0]
    assert g["platform"] == "gpu"
    assert g["kind"] == torch.cuda.get_device_name(0)
    assert g["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert g["peak_bytes_in_use"] >= g["bytes_in_use"]
    assert g["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert g["largest_alloc_size"] >= x.numel() * 4
    del x


def test_captured_program_cost(dev):
    """A captured program's cost is counted on its warm-up: a hand-written
    kernel charges its own FLOPs and bytes (it is no aten op), a product
    counts as on the CPU, and ``temp_bytes`` is the graph's pool."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ProgramCache, ProgramSpec, specs
    mean = torch.randn((4, 1000), device=dev)
    sq = mean * mean + 1.0
    spec = ProgramSpec(name="diag_std", key=("diag_std",),
                       make=lambda ctx: lambda m, s: (
                           ops.diag_std_leaves([m], [s])[0],),
                       in_kinds=("replicated", "replicated"))
    before = swag_moments.diag_std_leaves.launches
    prog = ProgramCache().program(spec, (mean, sq))
    assert prog.graph is not None
    assert swag_moments.diag_std_leaves.launches == before + 1  # warm-up
    cost = prog.cost()
    assert cost["flops"] == 4 * 4000
    assert cost["bytes_accessed"] == 3 * 4000 * 4
    assert cost["memory"]["temp_bytes"] == prog.pool_bytes
    # a product: the same count captured on the card as eager on the CPU
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3, 5, 4), generator=gen)

    def fwd(p, b):
        return torch.einsum("bi,pio->pbo", b["x"], p["w"])

    counts = []
    for d in (dev, torch.device("cpu")):
        args = ({"w": w.to(d)}, {"x": torch.ones((6, 5), device=d)},
                torch.ones(3, device=d))
        p = ProgramCache().program(specs.ensemble_predict(fwd), args)
        p(*args)
        counts.append(p.cost()["flops"])
    assert counts[0] == counts[1] == 2 * 6 * 5 * 4 * 3


# -- the decoder-only zoo's shapes: gemma3's hd 256, qwen3-moe's verify --------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [160, 256])
@pytest.mark.parametrize("G,S", [(1, 1), (2, 33), (2, 300), (1, 1200)])
def test_flash_kernel_wide_heads(dev, G, S, hd, causal, dtype, tol):
    """hd past 128 (gemma3: 256) takes the wide tiles (4 warps, 32 keys;
    2 warps on a small grid) within Hopper's shared memory."""
    gen = torch.Generator(device=dev).manual_seed(S * 7 + hd + G)
    q, k, v = (torch.randn((2, 1, S, h, hd), generator=gen,
                           device=dev).to(dtype) for h in (4 * G, 4, 4))
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,G", [(64, 1), (64, 8), (256, 1), (256, 8)])
@pytest.mark.parametrize("S,prefix", [(1, 1), (40, 37), (300, 256),
                                      (300, 64), (264, 300)])
def test_flash_kernel_prefix_mask(dev, S, prefix, hd, G, dtype, tol):
    """The prefix-LM mask (key j visible to query i iff j <= i or j <
    prefix: paligemma's 256 patches) at hd 64 and 256, one kv head under
    1 and 8 query heads; prefixes off and on the tile grid and past S."""
    gen = torch.Generator(device=dev).manual_seed(S * 5 + prefix + hd + G)
    q, k, v = (torch.randn((2, 2, S, h, hd), generator=gen,
                           device=dev).to(dtype) for h in (G, 1, 1))
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal=True,
                                       prefix_len=prefix)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                               prefix_len=prefix)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,KVH,hd,lens", [
    (8, 5, 64, 4, 128, [40, 17, -1, 100, 5, 300, 0, 63]),   # qwen3-moe verify
    (2, 3, 96, 2, 128, [9, 70]),                           # 3 row blocks
])
def test_window_kernel_rows_split_over_blocks(dev, dtype, B, W, H, KVH, hd,
                                              lens):
    """W * G * hd past 4096 entries: a kv head's query rows split over
    blocks (``split_walk.block_rows``), against the plain version."""
    from repro_torch.kernels import split_walk
    heads, row_blocks = split_walk.block_rows(KVH, W * (H // KVH), hd, 32,
                                              4 if dtype == torch.float32
                                              else 2)
    assert heads == 1 and row_blocks > 1
    args = _window_case(B + W, 1, B, W, H, KVH, hd, 16, 32, lens, dtype, dev)
    out = window_kernel.paged_decode_window_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_decode_window_attention(*args)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert out[:, b].abs().max().item() == 0.0


def test_window_kernel_w1_with_split_rows_matches_single_token_kernel(dev):
    """G * hd = 8192 entries at W = 1: both kernels split the rows the same
    way and return the same bits."""
    q, k, v, bt, sl = _case(5, 2, 3, 128, 2, 128, 16, 8, [0, 47, 100],
                            torch.float32, dev)
    single = kernel.paged_decode_attention(q, k, v, bt, sl)
    window = window_kernel.paged_decode_window_attention(q[:, :, None], k, v,
                                                         bt, sl)
    assert (window[:, :, 0] - single).abs().max().item() == 0.0
    want = ref.paged_decode_attention(q, k, v, bt, sl)
    assert (single - want).abs().max().item() < 1e-4
