"""Port tests that need an NVIDIA card (marker ``cuda``; skipped
elsewhere). They import no JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernel is held against its plain PyTorch version on the card on
the ``tests/test_paged.py`` sweep with a particle axis of 2 and NaN in
every stale slot, within 1e-4 with fp32 and with bf16 pages: both sides
widen the same bf16 values and accumulate in fp32, so bf16 pages leave
no rounding gap between them. A small ``serve_decode`` then runs on the
card, where every decode step goes through the kernel, and on the CPU,
where the same weights take the plain version; both emit the same
tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import ParticleModule, PushDistribution
from repro_torch.core.tree import tree_map
from repro_torch.kernels import paged_decode_attention as kernel
from repro_torch.kernels import ref
from repro_torch.models import api
from repro_torch.serve import serve_decode

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


def _case(seed, P, B, H, KVH, hd, ps, n_pmax, lens, dtype, dev):
    NP = B * n_pmax + 2
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
