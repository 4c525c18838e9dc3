"""The port's window, prefill and dense-decode attention against the JAX
package.

The plain PyTorch versions (what the port runs on the CPU, and the
references the CUDA kernels are held against on the card) are checked
against the Pallas kernels in interpret mode, over a leading particle axis
of 2 as serving stacks it:

  * ``paged_decode_window_attention`` on the ``tests/test_speculative.py``
    shapes, within 1e-4. Stale slots are finite here: the Pallas window
    kernel zeroes the weights of invalid columns but not their value rows,
    so planted NaN would leak through ``0 * NaN`` on the JAX side (the
    port masks both; NaN is planted in the card tests). With W = 1 the
    window equals the port's single-token paged attention within 1e-6, a
    truncated window keeps the earlier rows within 1e-5, and inactive rows
    are exact zeros;
  * ``flash_attention`` on the ``tests/test_kernels.py`` sweep within 2e-5,
    and the dtype cases (fp32 2e-5, bf16 2e-2);
  * ``decode_attention`` on the decode and ragged-tail sweeps within 2e-5,
    and a row with every slot empty (k_pos all -1): exact zeros, as the
    Pallas kernel gives (the reference's jnp oracle would give the mean of
    v there; the kernel is what the port follows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattention
from repro.kernels import decode_attention as jdecode
from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_window_attention as twindow

P = 2


def _window_case(seed, B, W, H, KVH, hd, ps, n_pmax, lens):
    """q (P, B, W, H, hd), pages (P, NP, ps, KVH, hd) and block tables
    with the PagePool conventions (each row owns the pages through its
    window); stale slots are finite."""
    NP = B * n_pmax + 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, B, W, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, NP, ps, KVH, hd)).astype(np.float32)
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        for i in range((sl + W - 1) // ps + 1):
            bt[b, i] = free.pop()
    return q, k, v, bt, np.asarray(lens, np.int32)


def _port_window(q, k, v, bt, sl):
    return tops.paged_decode_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bt, sl))).numpy()


@pytest.mark.parametrize("B,W,H,KVH,hd,ps,n_pmax,lens", [
    (2, 3, 4, 2, 16, 8, 4, [13, 20]),       # GQA, mixed lengths
    (3, 5, 8, 1, 8, 4, 8, [0, 9, 17]),      # MQA, window > page
    (2, 2, 4, 4, 8, 8, 3, [-1, 11]),        # MHA + inactive row
])
def test_window_plain_matches_jax_kernel(B, W, H, KVH, hd, ps, n_pmax, lens):
    q, k, v, bt, sl = _window_case(B * 3 + W, B, W, H, KVH, hd, ps, n_pmax,
                                   lens)
    jbt, jsl = jnp.asarray(bt), jnp.asarray(sl)
    want = np.asarray(jax.vmap(
        lambda qq, kk, vv: jops.paged_decode_window_attention(
            qq, kk, vv, jbt, jsl))(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    out = _port_window(q, k, v, bt, sl)
    assert np.abs(out - want).max() < 1e-4
    for b, L in enumerate(lens):
        if L < 0:
            assert np.abs(out[:, b]).max() == 0.0


def test_window_w1_matches_single_token_plain():
    q, k, v, bt, sl = _window_case(7, 2, 1, 4, 2, 16, 8, 3, [12, 19])
    single = tops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q[:, :, 0], k, v, bt, sl))).numpy()
    window = _port_window(q, k, v, bt, sl)
    assert np.abs(window[:, :, 0] - single).max() < 1e-6


def test_window_causal_within_window():
    """Query w sees no column past seq_len + w: truncating the window
    leaves the earlier rows as they were."""
    q, k, v, bt, sl = _window_case(3, 2, 4, 4, 2, 8, 4, 4, [5, 9])
    full = _port_window(q, k, v, bt, sl)
    short = _port_window(np.ascontiguousarray(q[:, :, :2]), k, v, bt, sl)
    assert np.abs(full[:, :, :2] - short).max() < 1e-5


def test_window_plain_masks_value_rows_past_each_query():
    """NaN in the window slots a query may not see (and past the window)
    stays out of that query's output."""
    q, k, v, bt, sl = _window_case(4, 2, 3, 4, 2, 8, 4, 4, [5, 9])
    want = _port_window(q, k, v, bt, sl)
    for b, L in enumerate(sl):
        page, slot = bt[b, (L + 1) // 4], (L + 1) % 4
        k[:, page, slot] = np.nan           # column L + 1: seen by w >= 1
        v[:, page, slot] = np.nan
    out = _port_window(q, k, v, bt, sl)
    assert np.isfinite(out[:, :, 0]).all()
    assert np.abs(out[:, :, 0] - want[:, :, 0]).max() == 0.0


FLASH_SWEEP = [
    (1, 64, 4, 2, 32, True, 16, 16),
    (2, 50, 4, 1, 16, True, 16, 32),
    (1, 128, 8, 8, 64, False, 32, 32),
    (2, 33, 2, 2, 8, True, 16, 16),
]


def _jax_flash(q, k, v, causal, qb, kb):
    """The Pallas kernel (interpret mode) on each particle of (P, ...)."""
    return np.stack([np.asarray(jattention.flash_attention(
        jnp.asarray(q[p]), jnp.asarray(k[p]), jnp.asarray(v[p]),
        causal=causal, q_block=qb, k_block=kb)).astype(np.float32)
        for p in range(q.shape[0])])


@pytest.mark.parametrize("B,S,H,KVH,hd,causal,qb,kb", FLASH_SWEEP)
def test_flash_plain_matches_jax_kernel(B, S, H, KVH, hd, causal, qb, kb):
    rng = np.random.default_rng(B * S)
    q = rng.standard_normal((P, B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, B, S, KVH, hd)).astype(np.float32)
    want = _jax_flash(q, k, v, causal, qb, kb)
    out = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal).numpy()
    assert np.abs(out - want).max() < 2e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_plain_dtypes(dtype, tol):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((P, 1, 64, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = np.stack([np.asarray(jattention.flash_attention(
        jq[p], jk[p], jv[p], causal=True, q_block=16,
        k_block=16)).astype(np.float32) for p in range(P)])
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    out = tops.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == getattr(torch, dtype)
    exact = tops.flash_attention(tq.float(), tk.float(), tv.float(),
                                 causal=True).numpy()
    assert np.abs(out.float().numpy() - want).max() < tol
    assert np.abs(out.float().numpy() - exact).max() < tol


def _decode_case(seed, B, C, H, KVH, hd, holes):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, B, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, B, C, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((P, B, C, KVH, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    if holes:                   # ring-cache style: some slots empty
        pos[rng.random((B, C)) > 0.8] = -1
    return q, k, v, pos


def _check_decode(q, k, v, pos, cb):
    want = np.stack([np.asarray(jdecode.decode_attention(
        jnp.asarray(q[p][:, None]), jnp.asarray(k[p]), jnp.asarray(v[p]),
        jnp.asarray(pos), c_block=cb))[:, 0] for p in range(P)])
    out = tops.decode_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, pos))).numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - want).max() < 2e-5


@pytest.mark.parametrize("B,C,H,KVH,hd,cb,holes", [
    (2, 64, 4, 2, 32, 16, False),
    (1, 100, 8, 1, 16, 32, True),   # MQA + ring-cache holes + ragged tail
    (3, 33, 4, 4, 8, 16, True),
])
def test_decode_plain_matches_jax_kernel(B, C, H, KVH, hd, cb, holes):
    _check_decode(*_decode_case(C, B, C, H, KVH, hd, holes), cb)


@pytest.mark.parametrize("C,cb", [(100, 32), (33, 16), (7, 512), (65, 64)])
def test_decode_plain_ragged_tail(C, cb):
    _check_decode(*_decode_case(C, 2, C, 4, 2, 16, False), cb)


@pytest.mark.parametrize("B,row,C,cb", [(3, 1, 40, 16), (2, 0, 7, 512),
                                        (4, 3, 100, 32)])
def test_decode_plain_all_empty_row_is_zeros(B, row, C, cb):
    """A row whose k_pos are all -1: the Pallas kernel zeroes p and v and
    divides by max(l, 1e-30), so the row is zeros; the plain version
    (what the CUDA kernel is held against) must give the same exact
    zeros, and the other rows must still match."""
    q, k, v, pos = _decode_case(C + row, B, C, 4, 2, 16, True)
    pos[row] = -1
    _check_decode(q, k, v, pos, cb)
    want = np.asarray(jdecode.decode_attention(
        jnp.asarray(q[0][:, None]), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(pos), c_block=cb))[:, 0]
    assert (want[row] == 0.0).all()
    out = tops.decode_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, pos)))
    assert (out[:, row] == 0.0).all()


@pytest.mark.parametrize("name", ["window", "flash", "decode"])
def test_dispatch_has_no_other_branch(name):
    """CPU tensors take the plain version; the CUDA wrapper refuses CPU
    tensors (it never falls back) and counts no launch; other devices
    raise."""
    q, k, v, bt, sl = (torch.from_numpy(a) for a in
                       _window_case(1, 2, 2, 4, 2, 8, 8, 2, [3, 9]))
    kd = torch.randn(P, 2, 6, 2, 8)
    pos = torch.arange(6, dtype=torch.int32).expand(2, 6).contiguous()
    wrapper, op, args = {
        "window": (twindow.paged_decode_window_attention,
                   tops.paged_decode_window_attention, (q, k, v, bt, sl)),
        "flash": (tflash.flash_attention, tops.flash_attention,
                  (torch.randn(P, 2, 6, 4, 8), kd, kd)),
        "decode": (tdecode.decode_attention, tops.decode_attention,
                   (q[:, :, 0].contiguous(), kd, kd, pos)),
    }[name]
    assert torch.isfinite(op(*args)).all()
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="device"):
        op(*(a.to("meta") for a in args))
