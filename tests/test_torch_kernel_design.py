"""The arithmetic of the Hopper attention kernels, emulated on the CPU.

The CUDA kernels run only on the card, so the two choices that their
accuracy rests on are checked here in plain PyTorch:

  * ``csrc/flash_attention.cu`` takes its fp32 products on the tensor
    cores as three TF32 products (3xTF32): each operand splits into
    ``big = tf32(x)`` and ``small = tf32(x - big)``, and a product is
    ``small*big + big*small + big*big``. The emulation rounds to TF32 as
    ``cvt.rna.tf32.f32`` does (round to nearest, ties away from zero, the
    low 13 mantissa bits cleared) and runs the kernel's online softmax over
    its key tiles. It is held against the port's plain version and the JAX
    reference within 2e-5 (the reference's tolerance,
    ``tests/test_kernels.py``); one TF32 product alone misses 2e-5, which
    is why the kernel keeps three.
  * ``csrc/paged_decode_window_attention.cu`` splits each row's page walk
    across blocks by the wrapper's plan (``split_plan`` /
    ``split_ranges``) and merges the splits' partials in split order. The
    plan covers every live page of every row exactly once for every
    ``seq_len`` in ``[-1, n_pmax * ps - W]``; the split-then-merge
    emulation, with NaN planted past every window and in unowned pages,
    matches the plain version within 1e-6, and at W = 1 the single-token
    plain version within 1e-6.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.paged_decode_window_attention import (split_plan,
                                                               split_ranges)

NEG_INF = -1e30


# -- 3xTF32 flash attention ---------------------------------------------------

def tf32(x):
    """Round fp32 to TF32 as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, products):
    """a @ b with TF32 operands: one product, or the 3xTF32 split."""
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulated_flash(q, k, v, *, causal, products, tile=64):
    """The kernel's online softmax over key tiles, rows r = t * G + g of
    each kv head, both products through ``tf32_matmul``."""
    P, B, S, H, hd = q.shape
    KVH = k.shape[3]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(P * B, S, KVH, G, hd).permute(0, 2, 1, 3, 4)
    qr = qr.reshape(P * B, KVH, S * G, hd)
    kr = k.reshape(P * B, S, KVH, hd).transpose(1, 2)
    vr = v.reshape(P * B, S, KVH, hd).transpose(1, 2)
    pos = torch.arange(S * G) // G
    m = torch.full((P * B, KVH, S * G), NEG_INF)
    l = torch.zeros((P * B, KVH, S * G))
    acc = torch.zeros((P * B, KVH, S * G, hd))
    for k0 in range(0, S, tile):
        key = torch.arange(k0, min(k0 + tile, S))
        s = tf32_matmul(qr, kr[:, :, k0:k0 + tile].transpose(-1, -2),
                        products) * scale
        ok = (key[None, :] <= pos[:, None]) if causal else \
            torch.ones(S * G, len(key), dtype=torch.bool)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + tf32_matmul(p, vr[:, :, k0:k0 + tile],
                                                  products)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    out = out.reshape(P * B, KVH, S, G, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(P, B, S, H, hd)


def _flash_inputs(seed, S, H, KVH, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 1, S, h, hd)).astype(np.float32)
            for h in (H, KVH, KVH)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
def test_3xtf32_flash_matches_reference(G, causal):
    q, k, v = _flash_inputs(G, 128, 2 * G, 2, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = emulated_flash(tq, tk, tv, causal=causal, products=3)
    want = ref.flash_attention(tq, tk, tv, causal=causal)
    assert (got - want).abs().max().item() < 2e-5
    for p in range(2):
        jwant = np.asarray(jref.flash_attention(
            jnp.asarray(q[p]), jnp.asarray(k[p]), jnp.asarray(v[p]),
            causal=causal))
        assert np.abs(got[p].numpy() - jwant).max() < 2e-5


@pytest.mark.parametrize("G", [1, 2])
def test_one_tf32_product_misses_the_reference_tolerance(G):
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(10 + G, 128,
                                                          2 * G, 2, 64))
    want = ref.flash_attention(q, k, v, causal=True)
    one = (emulated_flash(q, k, v, causal=True, products=1) - want).abs()
    three = (emulated_flash(q, k, v, causal=True, products=3) - want).abs()
    assert one.max().item() > 2e-5
    assert three.max().item() < one.max().item() / 20


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(tf32(x), want)
    big = tf32(x)
    assert torch.equal(big + tf32(x - big), x)


# -- the window kernel's split plan -------------------------------------------

PLANS = [(256, 16, 5), (4, 8, 3), (8, 4, 5), (16, 8, 4), (3, 8, 3),
         (129, 16, 5), (1, 16, 1), (40, 2, 7), (10, 32, 8)]


@pytest.mark.parametrize("n_pmax,ps,W", PLANS)
def test_split_plan_covers_every_live_page_once(n_pmax, ps, W):
    plan = split_plan(n_pmax, ps, W)
    stage, floor, n_splits = plan
    assert 1 <= stage <= floor and 1 <= n_splits <= 8
    assert floor * ps >= W
    for sl in range(-1, n_pmax * ps - W + 1):
        ranges = split_ranges(plan, sl, W, ps, n_pmax)
        assert len(ranges) == n_splits
        pages = [p for a, z in ranges for p in range(a, z)]
        live = 0 if sl < 0 else min((sl + W - 1) // ps + 1, n_pmax)
        assert pages == list(range(live))
        # splits in order; the empty ones only past the live pages
        used = [a < z for a, z in ranges]
        assert used == sorted(used, reverse=True)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 600), st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       st.integers(1, 8), st.data())
def test_split_plan_property(n_pmax, ps, W, data):
    if n_pmax * ps < W:
        return
    plan = split_plan(n_pmax, ps, W)
    sl = data.draw(st.integers(-1, n_pmax * ps - W))
    ranges = split_ranges(plan, sl, W, ps, n_pmax)
    pages = [p for a, z in ranges for p in range(a, z)]
    live = 0 if sl < 0 else (sl + W - 1) // ps + 1
    assert live <= n_pmax
    assert pages == list(range(live))


def test_split_plan_at_the_serving_shape():
    # 256-page tables of 16 slots, W = 5: 2-page stages and splits, 8 splits;
    # a 100-token row uses 4 of them, a 2048-token row all 8
    plan = split_plan(256, 16, 5)
    assert plan == (2, 2, 8)
    assert sum(a < z for a, z in split_ranges(plan, 100, 5, 16, 256)) == 4
    assert sum(a < z for a, z in split_ranges(plan, 2048, 5, 16, 256)) == 8


# -- split-then-merge emulation of the window kernel --------------------------

def _window_case(seed, P, B, W, H, KVH, hd, ps, n_pmax, lens):
    """PagePool conventions; NaN past every window and in unowned pages."""
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
    return q, k, v, torch.from_numpy(bt), torch.tensor(lens, dtype=torch.int32)


def emulated_window(q, k_pages, v_pages, block_tables, seq_lens):
    """Each split walks its pages in stages with an online softmax and
    keeps (m, l, acc); a row with one split divides, else the partials
    merge in split order."""
    P, B, W, H, hd = q.shape
    _, NP, ps, KVH, _ = k_pages.shape
    G = H // KVH
    n_pmax = block_tables.shape[1]
    plan = split_plan(n_pmax, ps, W)
    stage = plan[0]
    qq = (q * (1.0 / math.sqrt(hd))).reshape(P, B, W, KVH, G, hd)
    out = torch.zeros_like(q)
    for b in range(B):
        sl = int(seq_lens[b])
        last = sl + W - 1
        parts = []
        for a, z in split_ranges(plan, sl, W, ps, n_pmax):
            if a == z:
                continue
            m = torch.full((P, W, KVH, G), NEG_INF)
            l = torch.zeros((P, W, KVH, G))
            acc = torch.zeros((P, W, KVH, G, hd))
            for pp in range(a, z, stage):
                cols = [(pi, c) for pi in range(pp, min(pp + stage, z))
                        for c in range(ps)]
                col = torch.tensor([pi * ps + c for pi, c in cols])
                page = [int(block_tables[b, pi]) for pi, _ in cols]
                ok = torch.tensor([0 <= pg < NP and pi * ps + c <= last
                                   for pg, (pi, c) in zip(page, cols)])
                idx = torch.tensor([pg if 0 <= pg < NP else 0 for pg in page])
                slot = torch.tensor([c for _, c in cols])
                kk = torch.where(ok[None, :, None, None],
                                 k_pages[:, idx, slot], 0.0)
                vv = torch.where(ok[None, :, None, None],
                                 v_pages[:, idx, slot], 0.0)
                valid = ok[None, :] & (col[None, :] <= sl + torch.arange(W)[:, None])
                valid = valid[None, :, None, None, :]             # p w n g c
                s = torch.einsum("pwngh,pcnh->pwngc", qq[:, b], kk)
                s = torch.where(valid, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                e = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
                l = l * corr + e.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "pwngc,pcnh->pwngh", e, vv)
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        if len(parts) == 1:
            o = parts[0][2] / parts[0][1].clamp(min=1e-30)[..., None]
        else:
            mm = torch.stack([p[0] for p in parts]).amax(0)
            ll = torch.zeros_like(mm)
            oo = torch.zeros_like(parts[0][2])
            for pm, pl, pa in parts:
                f = torch.exp(pm - mm)
                ll = ll + pl * f
                oo = oo + pa * f[..., None]
            o = oo / ll.clamp(min=1e-30)[..., None]
        out[:, b] = o.reshape(P, W, H, hd)
    return out


WINDOW_CASES = [
    (4, 5, 16, 16, 16, 16, 64, [40, 17, -1, 100]),    # qwen-like heads, splits
    (2, 3, 4, 2, 16, 8, 4, [13, 20]),                 # GQA, one split each
    (3, 5, 8, 1, 8, 4, 24, [0, 9, 70]),               # MQA, window > page
    (4, 4, 4, 4, 8, 8, 40, [-1, 47, 299, 316]),       # many splits, edges
]


@pytest.mark.parametrize("B,W,H,KVH,hd,ps,n_pmax,lens", WINDOW_CASES)
def test_split_merge_matches_plain(B, W, H, KVH, hd, ps, n_pmax, lens):
    args = _window_case(B + W + ps, 2, B, W, H, KVH, hd, ps, n_pmax, lens)
    got = emulated_window(*args)
    want = ref.paged_decode_window_attention(*args)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-6
    for b, L in enumerate(lens):
        if L < 0:
            assert got[:, b].abs().max().item() == 0.0


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", [
    (2, 4, 2, 32, 16, 4, [47, 63]),
    (3, 8, 1, 16, 8, 40, [0, 33, 300]),
    (4, 6, 3, 64, 4, 64, [5, -1, 255, 31]),
])
def test_split_merge_w1_matches_single_token_plain(B, H, KVH, hd, ps, n_pmax,
                                                   lens):
    q, k, v, bt, sl = _window_case(B * 7 + ps, 2, B, 1, H, KVH, hd, ps,
                                   n_pmax, lens)
    got = emulated_window(q, k, v, bt, sl)[:, :, 0]
    want = ref.paged_decode_attention(q[:, :, 0], k, v, bt, sl)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-6
