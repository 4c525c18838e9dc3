"""The port's paged decode attention against the JAX package.

The plain PyTorch version (what the port runs on the CPU, and the
reference the CUDA kernel is held against on the card) is checked against
the Pallas kernel in interpret mode — vmapped over a leading particle
axis, as serving stacks it — and against the jnp oracle, on the
``tests/test_paged.py`` sweep. Stale slots past each sequence's tail and
every unowned page hold NaN: neither side may leak it. Tolerance 1e-4 (the
reference's own for paged kernels); inactive rows must be exact zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as tkernel

P = 2
SWEEP = [
    (2, 4, 2, 32, 16, 4, [47, 63]),        # GQA, partial + full pages
    (3, 8, 1, 16, 8, 6, [0, 33, 21]),      # MQA, single-token row
    (2, 4, 4, 8, 16, 3, [-1, 40]),         # MHA + an inactive row
    (4, 6, 3, 64, 32, 2, [5, -1, 63, 31]), # group=2, mixed ragged
]


def _case(seed, B, H, KVH, hd, ps, n_pmax, lens, *, stale_nan):
    """Pages and block tables with the PagePool conventions; with
    ``stale_nan`` the tail slots of each row's last page and every page
    no row owns hold NaN (a previous owner's garbage)."""
    NP = B * n_pmax + 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, B, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32)
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    owned = set()
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        for i in range(sl // ps + 1):
            bt[b, i] = free.pop()
            owned.add(int(bt[b, i]))
        if stale_nan:
            last = bt[b, sl // ps]
            k[:, last, sl % ps + 1:] = np.nan
            v[:, last, sl % ps + 1:] = np.nan
    if stale_nan:
        for page in set(range(NP)) - owned:
            k[:, page] = np.nan
            v[:, page] = np.nan
    return q, k, v, bt, np.asarray(lens, np.int32)


def _port(q, k, v, bt, sl):
    return tops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(sl)).numpy()


def _check_inactive(out, lens):
    for b, L in enumerate(lens):
        if L < 0:
            assert np.abs(out[:, b]).max() == 0.0


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", SWEEP)
def test_plain_matches_jax_kernel_with_stale_nan(B, H, KVH, hd, ps, n_pmax,
                                                 lens):
    q, k, v, bt, sl = _case(B * 7 + ps, B, H, KVH, hd, ps, n_pmax, lens,
                            stale_nan=True)
    jbt, jsl = jnp.asarray(bt), jnp.asarray(sl)
    want = jax.vmap(lambda qq, kk, vv: jops.paged_decode_attention(
        qq[:, None], kk, vv, jbt, jsl))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    want = np.asarray(want)[:, :, 0]
    out = _port(q, k, v, bt, sl)
    assert np.isfinite(out).all() and np.isfinite(want).all()
    assert np.abs(out - want).max() < 1e-4
    _check_inactive(out, lens)


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", SWEEP)
def test_plain_matches_jax_reference(B, H, KVH, hd, ps, n_pmax, lens):
    # the jnp oracle multiplies masked weights into v, so it is compared
    # on finite stale slots (it would leak planted NaN; the kernel and
    # the port do not)
    q, k, v, bt, sl = _case(B * 7 + ps, B, H, KVH, hd, ps, n_pmax, lens,
                            stale_nan=False)
    out = _port(q, k, v, bt, sl)
    for p in range(P):
        want = np.asarray(jref.paged_decode_attention(
            jnp.asarray(q[p][:, None]), jnp.asarray(k[p]), jnp.asarray(v[p]),
            jnp.asarray(bt), jnp.asarray(sl)))[:, 0]
        assert np.abs(out[p] - want).max() < 1e-4
    _check_inactive(out, lens)


def test_bf16_pages_plain_matches_fp32_on_rounded_pages():
    """bf16 pages are widened to fp32 before any arithmetic: the result
    equals the fp32 computation on the rounded pages."""
    q, k, v, bt, sl = _case(5, 2, 4, 2, 32, 16, 4, [47, 63], stale_nan=True)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    out = tops.paged_decode_attention(torch.from_numpy(q), kb, vb,
                                      torch.from_numpy(bt),
                                      torch.from_numpy(sl))
    want = tops.paged_decode_attention(torch.from_numpy(q), kb.float(),
                                       vb.float(), torch.from_numpy(bt),
                                       torch.from_numpy(sl))
    assert out.dtype == torch.float32
    assert torch.equal(out, want)


def test_dispatch_has_no_other_branch():
    """CPU tensors take the plain version; the CUDA wrapper refuses CPU
    tensors (it never falls back) and counts no launch; other devices
    raise."""
    q, k, v, bt, sl = (torch.from_numpy(a) for a in _case(
        1, 2, 4, 2, 8, 8, 2, [3, 9], stale_nan=False))
    before = tkernel.paged_decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.paged_decode_attention(q, k, v, bt, sl)
    assert tkernel.paged_decode_attention.launches == before
    with pytest.raises(ValueError, match="device"):
        tops.paged_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                    bt.to("meta"), sl.to("meta"))
