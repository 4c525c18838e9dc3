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
  * ``csrc/split_walk.cuh`` is the walk of the three decode kernels: each
    row's walk is split across blocks by the wrapper's plan
    (``kernels/split_walk.py``: ``split_plan`` / ``split_ranges`` /
    ``stage_ranges``) and the splits' partials merge in split order. The
    plan covers every live page of every row exactly once for every
    ``seq_len`` in ``[-1, n_pmax * ps - W]``, and the dense plan every slot
    of a C-slot cache once, whatever k_pos holds. The split-then-merge
    emulation, with NaN planted past every window, in unowned pages and in
    empty cache slots, matches the plain versions within 1e-6: the window
    kernel's, the single-token kernel's (the walk at W = 1, with its own
    plan) and the dense-cache kernel's. The emulated window at W = 1 and
    the emulated single-token walk are equal bit for bit.
  * Past 4096 accumulator entries a block (qwen3-moe's verify window: W
    5 x G 16 x hd 128) a kv head's query rows split over blocks
    (``split_walk.block_rows`` / ``row_ranges``): every query row of
    every kv head in exactly one block, each block within the entry and
    shared-memory limits; the walk of one block's rows, with every other
    row of q NaN, gives those rows the plain version's values.
  * gemma3's hd 256 takes the flash kernel's wide tiles (4 or 2 warps,
    32 keys): within Hopper's shared memory at every hd up to 256, which
    the 128-row, 64-key tiles are not past hd 128; the 3xTF32 emulation
    over 32-key tiles at hd 256 holds the plain version and the
    reference at 2e-5.
  * The prefix-LM mask (paligemma: key j visible to query i iff j <= i
    or j < prefix_len): #5's tile rules (``flash_schedule``: the tiles a
    block visits, a warp's skip, the unmasked tiles) cover every visible
    pair and leave no hidden pair unmasked; the 3xTF32 emulation over
    those tiles holds the plain version and the reference at 2e-5 at hd
    64 and 256, G 1 and 8; ``cost()`` counts exactly the visible pairs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.kernels import svgd_rbf as jsvgd_rbf
from repro_torch.kernels import ref
from repro_torch.kernels import split_walk
from repro_torch.kernels.flash_attention import cost as flash_cost
from repro_torch.kernels.flash_attention import visible_pairs
from repro_torch.kernels.split_walk import (dense_plan, split_plan,
                                            split_ranges, stage_ranges)
from repro_torch.kernels.svgd_rbf import sqdist_plan

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


def emulated_walk(q, seq_lens, plan, ps, n_pmax, KVH, slots):
    """The split walk of ``csrc/split_walk.cuh``: q (P, B, W, H, hd), row
    b's query w at position seq_lens[b] + w; ``slots(b, cols)`` gives the
    K and V rows (P, n, KVH, hd) of the row's columns and whether each may
    be read. Each split walks its stages with an online softmax and keeps
    (m, l, acc); a row with one split divides, else the partials merge in
    split order. Unreadable columns and columns past the window are
    zero-filled before any arithmetic, as the kernel's loads do."""
    P, B, W, H, hd = q.shape
    G = H // KVH
    qq = (q * (1.0 / math.sqrt(hd))).reshape(P, B, W, KVH, G, hd)
    out = torch.zeros_like(q)
    for b in range(B):
        sl = int(seq_lens[b])
        parts = []
        for a, z in split_ranges(plan, sl, W, ps, n_pmax):
            if a == z:
                continue
            m = torch.full((P, W, KVH, G), NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros((P, W, KVH, G, hd))
            for s0, s1 in stage_ranges(plan, a, z):
                col = torch.arange(s0 * ps, s1 * ps)
                kk, vv, readable = slots(b, col)
                ok = readable & (col <= sl + W - 1)
                kk = torch.where(ok[None, :, None, None], kk, 0.0)
                vv = torch.where(ok[None, :, None, None], vv, 0.0)
                valid = ok[None, :] & (col[None, :]
                                       <= sl + torch.arange(W)[:, None])
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


def paged_slots(k_pages, v_pages, block_tables):
    """The block-table column rule: a page id outside the pool is never
    read."""
    NP, ps = k_pages.shape[1:3]

    def slots(b, col):
        page = block_tables[b, col // ps].long()
        readable = (page >= 0) & (page < NP)
        idx = torch.where(readable, page, 0)
        return k_pages[:, idx, col % ps], v_pages[:, idx, col % ps], readable
    return slots


def emulated_window(q, k_pages, v_pages, block_tables, seq_lens):
    """The drafted-window kernel: the walk at W = q.shape[2]."""
    _, _, ps, KVH, _ = k_pages.shape
    n_pmax = block_tables.shape[1]
    return emulated_walk(q, seq_lens, split_plan(n_pmax, ps, q.shape[2]), ps,
                         n_pmax, KVH,
                         paged_slots(k_pages, v_pages, block_tables))


def emulated_paged(q, k_pages, v_pages, block_tables, seq_lens):
    """The single-token kernel: one query row a kv head, its own plan."""
    _, _, ps, KVH, _ = k_pages.shape
    n_pmax = block_tables.shape[1]
    return emulated_walk(q[:, :, None], seq_lens, split_plan(n_pmax, ps, 1),
                         ps, n_pmax, KVH,
                         paged_slots(k_pages, v_pages, block_tables))[:, :, 0]


def emulated_dense(q, k_cache, v_cache, k_pos):
    """The dense-cache kernel: a row of C one-slot units, every row's query
    at C - 1, a slot readable where k_pos says it is filled."""
    C, KVH = k_cache.shape[2:4]

    def slots(b, col):
        return k_cache[:, b, col], v_cache[:, b, col], k_pos[b, col] >= 0
    sl = torch.full((q.shape[1],), C - 1)
    return emulated_walk(q[:, :, None], sl, dense_plan(C), 1, C, KVH,
                         slots)[:, :, 0]


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


# -- the single-token kernel: the walk at W = 1 --------------------------------

PAGED_CASES = [
    (4, 16, 16, 16, 16, 64, [40, 17, -1, 100]),   # qwen-like heads, splits
    (2, 4, 2, 32, 16, 4, [47, 63]),               # GQA, one split each
    (3, 8, 1, 16, 8, 40, [0, 33, 300]),           # MQA, many splits
    (4, 6, 3, 8, 4, 64, [5, -1, 255, 31]),        # page edges, full table
    (3, 4, 4, 8, 16, 256, [15, 16, 2047]),        # 256-page tables
]


def _paged_case(seed, B, H, KVH, hd, ps, n_pmax, lens):
    q, k, v, bt, sl = _window_case(seed, 2, B, 1, H, KVH, hd, ps, n_pmax,
                                   lens)
    return q[:, :, 0], k, v, bt, sl


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", PAGED_CASES)
def test_single_token_split_merge_matches_plain(B, H, KVH, hd, ps, n_pmax,
                                                lens):
    q, k, v, bt, sl = _paged_case(B * 5 + ps, B, H, KVH, hd, ps, n_pmax, lens)
    got = emulated_paged(q, k, v, bt, sl)
    want = ref.paged_decode_attention(q, k, v, bt, sl)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-6
    for b, L in enumerate(lens):
        if L < 0:
            assert got[:, b].abs().max().item() == 0.0


@pytest.mark.parametrize("B,H,KVH,hd,ps,n_pmax,lens", PAGED_CASES)
def test_window_walk_at_w1_is_the_single_token_walk_bit_for_bit(
        B, H, KVH, hd, ps, n_pmax, lens):
    q, k, v, bt, sl = _paged_case(B * 5 + ps, B, H, KVH, hd, ps, n_pmax, lens)
    window = emulated_window(q[:, :, None], k, v, bt, sl)[:, :, 0]
    assert torch.equal(window, emulated_paged(q, k, v, bt, sl))


def test_single_token_plan_at_the_serving_and_draft_shapes():
    # 256-page tables of 16 slots: 2-page stages and splits, 8 splits; a
    # 100-token row uses 4 of them, 2 pages each, a 2048-token row all 8
    plan = split_plan(256, 16, 1)
    assert plan == (2, 2, 8)
    assert split_ranges(plan, 100, 1, 16, 256)[:5] == [(0, 2), (2, 4), (4, 6),
                                                      (6, 7), (7, 7)]
    assert split_ranges(plan, 2047, 1, 16, 256) == [
        (16 * s, 16 * s + 16) for s in range(8)]
    # the grid decides whether rows split at all: P=4 x 8 rows x 8 kv head
    # pairs is 256 blocks, one per SM or more on an H100 (132): no split;
    # the draft's one-particle call has 64 blocks and splits 8 ways
    assert split_plan(256, 16, 1, blocks=256, sms=132) == (2, 2, 1)
    assert split_plan(256, 16, 1, blocks=64, sms=132) == (2, 2, 8)
    assert dense_plan(97, blocks=256, sms=132) == (32, 32, 1)


# -- the dense-cache kernel: a plan over C slots --------------------------------

@settings(max_examples=200, deadline=None)
@given(st.integers(1, 3000), st.integers(1, 64), st.integers(1, 16),
       st.data())
def test_dense_plan_covers_every_slot_once(C, stage_cols, max_splits, data):
    """Every slot once, in order, in stages of at most ``stage_cols`` (the
    last of a split may be short: the ragged tail), whatever k_pos holds:
    the plan never reads it."""
    plan = dense_plan(C, stage_cols, max_splits)
    assert plan[0] == stage_cols and 1 <= plan[2] <= max_splits
    holes = data.draw(st.sets(st.integers(0, C - 1), max_size=64))
    a0 = data.draw(st.integers(0, C - 1))
    holes |= set(range(a0, min(C, a0 + data.draw(st.integers(0, 100)))))
    seen = []
    for a, z in split_ranges(plan, C - 1, 1, 1, C):
        for s0, s1 in stage_ranges(plan, a, z):
            assert 0 < s1 - s0 <= stage_cols
            seen.extend(range(s0, s1))
    assert seen == list(range(C))
    assert [c for c in seen if c not in holes] == sorted(
        set(range(C)) - holes)


def test_dense_plan_at_the_stateful_shapes():
    # C = 97 (phase 7): four splits, one 32-slot stage each, a 1-slot tail
    plan = dense_plan(97)
    assert plan == (32, 32, 4)
    assert split_ranges(plan, 96, 1, 1, 97) == [(0, 32), (32, 64), (64, 96),
                                                (96, 97)]
    # C = 2048: eight splits of eight stages
    plan = dense_plan(2048)
    assert plan == (32, 32, 8)
    assert [stage_ranges(plan, a, z)[-1] for a, z in
            split_ranges(plan, 2047, 1, 1, 2048)] == [
        (256 * s + 224, 256 * s + 256) for s in range(8)]


DENSE_CASES = [
    (3, 97, 4, 4, 16, "tail"),      # the phase-7 cache: 1-slot last split
    (2, 32, 4, 2, 8, "holes"),      # one split
    (2, 33, 8, 1, 16, "holes"),     # two splits, a 1-slot ragged tail
    (2, 300, 4, 2, 8, "gap"),       # all-empty stages inside a split
    (3, 1000, 2, 2, 8, "empty_row"),
    (1, 1, 2, 1, 4, "none"),
]


@pytest.mark.parametrize("B,C,H,KVH,hd,empty", DENSE_CASES)
def test_dense_split_merge_matches_plain(B, C, H, KVH, hd, empty):
    rng = np.random.default_rng(C + B)
    q = torch.from_numpy(rng.standard_normal((2, B, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, B, C, KVH, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, B, C, KVH, hd), np.float32))
    pos = torch.arange(C).expand(B, C).clone()
    if empty == "holes":
        pos[torch.from_numpy(rng.random((B, C)) < 0.2)] = -1
    elif empty == "gap":
        pos[:, 1:71] = -1
    elif empty == "tail":
        pos[:, 80:] = -1
    elif empty == "empty_row":
        pos[1] = -1
    k[:, pos < 0] = float("nan")
    v[:, pos < 0] = float("nan")
    pos = pos.to(torch.int32)
    got = emulated_dense(q, k, v, pos)
    want = ref.decode_attention(q, k, v, pos)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-6
    if empty == "empty_row":
        assert got[:, 1].abs().max().item() == 0.0


# -- pairwise_sqdist: the one-wave plan, chunk partials, fixed second stage -----

SM_SMEM = 233_472          # shared memory of a Hopper SM
BLOCK_SMEM_LIMIT = 232_448  # shared memory a Hopper block may use
SQDIST_STATIC = 8 * 64 * 4 + 8 * 4   # csrc/svgd_rbf.cu: red, barriers
# chip_smoke.py's SQDIST_SWEEP, then n = 64 and n > 64 at small D
SQDIST_CASES = [(2, 16), (4, 100), (8, 5000), (64, 12345), (3, 7), (64, 300),
                (72, 301), (9, 64)]


def _tile_rows(t, n):
    return range(t * 8, min(t * 8 + 8, n))


def _plan_cover(plan):
    """{tile pair: the column ranges its items get}, walking the blocks'
    items as the kernel does."""
    cover = {}
    for b in range(plan.grid):
        for item in plan.items(b):
            p, c = divmod(item, plan.nchunks)
            cover.setdefault(plan.pairs[p], []).append(plan.chunk(c))
    return cover


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 256), st.integers(1, 100_000),
       st.sampled_from([1, 7, 132]), st.integers(1, 4), st.booleans())
def test_sqdist_plan_covers_every_column_of_every_pair_once(n, D, sms, stages,
                                                            aligned):
    plan = sqdist_plan(n, D, sms, stages=stages, base_aligned=aligned)
    tiles = -(-n // 8)
    live = sorted((ti, tj) for ti in range(tiles) for tj in range(ti, tiles)
                  if any(i < j for i in _tile_rows(ti, n)
                         for j in _tile_rows(tj, n)))
    assert list(plan.pairs) == live
    # the kernel finds pair p by walking the row-major order of all pairs
    # ti <= tj: the plan's pairs must be a prefix of it
    order = [(ti, tj) for ti in range(tiles) for tj in range(ti, tiles)]
    assert list(plan.pairs) == order[:len(plan.pairs)]
    cover = _plan_cover(plan)
    assert sorted(cover) == live
    for ranges in cover.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == D
        assert all(a < z for a, z in ranges)
        assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))
    # the bulk path only where rows are 16-byte aligned, and every copy is
    bulk = D % 4 == 0 and aligned
    assert plan.path == ("bulk" if bulk else "plain")
    if bulk:
        assert plan.tile_cols % 4 == 0
        for c in range(plan.nchunks):
            a, z = plan.chunk(c)
            assert a % 4 == 0 and z % 4 == 0
        assert plan.smem == 4 * stages * plan.stage_rows * plan.tile_cols
        assert plan.smem + SQDIST_STATIC <= BLOCK_SMEM_LIMIT
    # at most one wave; the scratch is bounded by it
    assert 1 <= plan.blocks_per_sm <= 2
    assert plan.blocks_per_sm * (plan.smem + SQDIST_STATIC + 1024) <= SM_SMEM
    assert plan.grid <= sms * plan.blocks_per_sm
    assert plan.nchunks <= max(1, sms * plan.blocks_per_sm)
    # near-equal chunks
    sizes = [z - a for a, z in map(plan.chunk, range(plan.nchunks))]
    assert max(sizes) - min(sizes) <= plan.unit


def test_sqdist_plan_at_the_training_shape():
    # 8 ViT-MNIST particles x 19,775,360 on 132 SMs: one diagonal tile,
    # 264 chunks in one wave of two blocks an SM, 2 x 16 KB stages a block
    plan = sqdist_plan(8, 19_775_360, 132)
    assert plan.path == "bulk" and plan.pairs == ((0, 0),)
    assert (plan.nchunks, plan.grid, plan.blocks_per_sm) == (264, 264, 2)
    assert (plan.stages, plan.stage_rows, plan.tile_cols, plan.smem) == (
        2, 8, 512, 32768)
    assert [len(plan.items(b)) for b in range(plan.grid)] == [1] * 264
    # the probe's ring shapes: 4 stages of 64 KB leave room for one block
    # an SM; one block an SM halves the grid
    assert sqdist_plan(8, 19_775_360, 132, stages=3,
                       stage_bytes=65536).grid == 132
    assert sqdist_plan(8, 19_775_360, 132, blocks_per_sm=1).grid == 132
    with pytest.raises(ValueError):
        sqdist_plan(8, 19_775_360, 132, stages=4, stage_bytes=65536)
    with pytest.raises(ValueError):
        sqdist_plan(8, 100, 132, blocks_per_sm=3)
    # n = 256: 528 tile pairs already fill the wave, so one chunk each
    wide = sqdist_plan(256, 1_000_000, 132)
    assert len(wide.pairs) == 528 and wide.nchunks == 1 and wide.grid == 264
    # rows that cannot be bulk-copied take plain loads
    assert sqdist_plan(64, 12345, 132).path == "plain"
    assert sqdist_plan(3, 7, 132).path == "plain"
    assert sqdist_plan(8, 5000, 132, base_aligned=False).path == "plain"
    # one particle has no pair: no first stage
    assert sqdist_plan(1, 1000, 132).grid == 0


def emulated_sqdist(theta, mask, plan):
    """The kernel's two stages in fp32: each item's partial sums of
    (theta_i - theta_j)^2, i < j, over its chunk (dead rows selected to
    0), then one warp per pair: lane l adds chunks l, l + 32, ... in
    order, and a fixed xor-shuffle tree adds the lanes."""
    n = theta.shape[0]
    live = torch.ones(n, dtype=torch.bool) if mask is None else mask > 0
    x = torch.where(live[:, None], theta, torch.zeros(()))
    partial = torch.full((n, n, plan.nchunks), float("nan"))
    for b in range(plan.grid):
        for item in plan.items(b):
            p, c = divmod(item, plan.nchunks)
            ti, tj = plan.pairs[p]
            a, z = plan.chunk(c)
            ri, rj = list(_tile_rows(ti, n)), list(_tile_rows(tj, n))
            xi, xj = x[ri, a:z], x[rj, a:z]
            d = ((xi[:, None] - xj[None]) ** 2).sum(-1)
            for u, i in enumerate(ri):
                for w, j in enumerate(rj):
                    if i < j:
                        partial[i, j, c] = d[u, w]
    iu, ju = torch.triu_indices(n, n, 1)
    chunks = partial[iu, ju]                              # (pairs, nchunks)
    k = -(-plan.nchunks // 32)
    lanes = torch.zeros((len(iu), k * 32))
    lanes[:, :plan.nchunks] = chunks
    lanes = lanes.reshape(len(iu), k, 32)
    s = torch.zeros((len(iu), 32))
    for r in range(k):
        s = s + lanes[:, r]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    out = torch.zeros((n, n))
    out[iu, ju] = s[:, 0]
    out[ju, iu] = s[:, 0]
    return out


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("n,D", SQDIST_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_sqdist_two_stages_match_plain_and_reference(n, D, sms, masked):
    rng = np.random.default_rng(n * 31 + D)
    t = rng.standard_normal((n, D)).astype(np.float32) * 0.1
    m = np.ones(n, np.float32)
    if masked:
        m[[n - 1] + ([0] if n > 3 else [])] = 0.0
    t_nan = t.copy()
    t_nan[m == 0] = np.nan
    tm = torch.from_numpy(m) if masked else None
    plan = sqdist_plan(n, D, sms)
    got = emulated_sqdist(torch.from_numpy(t_nan), tm, plan)
    assert torch.isfinite(got).all()
    assert torch.equal(got, got.T)
    assert (got.diagonal() == 0).all()
    assert got.min().item() >= 0.0
    plain = ref.pairwise_sqdist(torch.from_numpy(t_nan), tm)
    assert (got - plain).abs().max().item() < 1e-3
    dense = jnp.where(jnp.asarray(m)[:, None] > 0, jnp.asarray(t), 0.0)
    pallas = np.asarray(jsvgd_rbf.pairwise_sqdist(dense, block_d=4096))
    assert np.abs(got.numpy() - pallas).max() < 1e-3


# -- wide heads: the flash kernel at hd 256 ------------------------------------

def flash_tiles(N, S, H, KVH, hd, sms):
    """(warps a block, keys a tile) that ``csrc/flash_attention.cu``
    launches: 16 query rows a warp; up to hd 128, 8 warps and 64 keys
    when that grid has two blocks an SM, else 2 warps and 32 keys; past
    hd 128, 4 warps and 32 keys when that grid has two blocks an SM,
    else 2 and 32."""
    warps, keys = (8, 64) if hd <= 128 else (4, 32)
    big = -(-(S * (H // KVH)) // (16 * warps)) * KVH * N
    return (warps, keys) if big >= 2 * sms else (2, 32)


def flash_smem_bytes(warps, keys, hd, itemsize):
    """Dynamic shared memory of a block (``smem_elems`` in the .cu): q
    rows and two stages of K and V rows at the padded strides."""
    r32, r64 = -(-hd // 32) * 32, -(-hd // 64) * 64
    ks, vs = (r32 + 8, r32 + 4) if itemsize == 4 else (r64 + 8, r64 + 8)
    return itemsize * ((16 * warps + 2 * keys) * ks + 2 * keys * vs)


def test_flash_tiles_fit_shared_memory_up_to_hd_256():
    for hd in range(1, 257):
        for itemsize in (4, 2):
            for S in (1, 128, 4096):
                nw, bn = flash_tiles(2, S, 8, 4, hd, 132)
                assert flash_smem_bytes(nw, bn, hd, itemsize) \
                    <= split_walk.MAX_SMEM, (hd, itemsize, S)
                assert (bn == 32) == (nw != 8)
    # the 128-row, 64-key tiles would not fit at gemma3's hd
    assert flash_smem_bytes(8, 64, 256, 4) > split_walk.MAX_SMEM
    # gemma3's prefill (P 2, 1,200 tokens, 8 heads over 4 kv heads): the
    # 4-warp tiles
    assert flash_tiles(2, 1200, 8, 4, 256, 132) == (4, 32)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_flash_at_hd_256_matches_reference(causal):
    q, k, v = _flash_inputs(3, 96, 4, 2, 256)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = emulated_flash(tq, tk, tv, causal=causal, products=3, tile=32)
    want = ref.flash_attention(tq, tk, tv, causal=causal)
    assert (got - want).abs().max().item() < 2e-5
    for p in range(2):
        jwant = np.asarray(jref.flash_attention(
            jnp.asarray(q[p]), jnp.asarray(k[p]), jnp.asarray(v[p]),
            causal=causal))
        assert np.abs(got[p].numpy() - jwant).max() < 2e-5


# -- the prefix-LM mask: which tiles #5 visits -------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the emulation's many small products: on a
    shared CPU a pool of threads waits on its slowest member (0.06 s
    against 7 s here). Values do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flash_schedule(S, G, warps, BN, causal, prefix):
    """{first row of a warp: [(first key of a tile, computed unmasked)]}:
    the tiles each warp of ``csrc/flash_attention.cu`` computes, in order,
    by its integer rules: a block visits n_kt tiles (causal: up to its
    last row and at least the prefix's tiles), a warp skips a tile past
    its last row unless the tile starts inside the prefix, and a tile
    wholly inside S, the rows and either the causal limit of the warp's
    first row or the prefix skips the mask."""
    rows, BM = S * G, 16 * warps
    out = {}
    for r0 in range(0, rows, BM):
        last_row = min(r0 + BM, rows) - 1
        pre_kt = min(prefix, S) + BN - 1
        n_kt = max(last_row // G // BN + 1, pre_kt // BN) if causal \
            else -(-S // BN)
        for wr0 in range(r0, min(r0 + BM, rows), 16):
            warp_last = (min(wr0 + 16, rows) - 1) // G
            tiles = []
            for kt in range(n_kt):
                k0 = kt * BN
                if causal and not (k0 <= warp_last or k0 < prefix):
                    continue
                full = (k0 + BN <= S and wr0 + 16 <= rows
                        and (not causal or k0 + BN - 1 <= wr0 // G
                             or k0 + BN <= prefix))
                tiles.append((k0, full))
            out[wr0] = tiles
    return out


def _visible(S, G, causal, prefix):
    """(rows S * G, keys S) bool: row r = t * G + g sees key j."""
    pos = torch.arange(S * G)[:, None] // G
    key = torch.arange(S)[None, :]
    return ((key <= pos) | (key < prefix)) if causal \
        else torch.ones(S * G, S, dtype=torch.bool)


@pytest.mark.parametrize("warps,BN", [(8, 64), (2, 32), (4, 32)])
def test_flash_tiles_cover_the_prefix_mask(warps, BN, one_thread):
    """Every visible (row, key) pair lies in a tile its warp computes, and
    a tile computed unmasked holds only visible pairs (inside S), for
    prefixes on and off the tile grid, past S and 0, G 1 and 8."""
    for S in (1, 17, 64, 100, 264):
        for G in (1, 8):
            for prefix in sorted({0, 1, 31, 32, 33, 64, 256, S, S + 5}):
                vis = _visible(S, G, True, prefix)
                for wr0, tiles in flash_schedule(S, G, warps, BN, True,
                                                 prefix).items():
                    rows = slice(wr0, min(wr0 + 16, S * G))
                    seen = torch.zeros(S, dtype=torch.bool)
                    for k0, full in tiles:
                        seen[k0:k0 + BN] = True
                        if full:
                            assert vis[rows, k0:k0 + BN].all(), (S, G,
                                                                 prefix, k0)
                    assert not (vis[rows] & ~seen).any(), (S, G, prefix, wr0)


def emulated_flash_tiles(q, k, v, *, prefix, warps, BN, causal=True):
    """The kernel's 3xTF32 online softmax warp by warp over the tiles of
    ``flash_schedule``, the mask applied only where a tile is not
    computed unmasked."""
    P, B, S, H, hd = q.shape
    KVH = k.shape[3]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(P * B, S, KVH, G, hd).permute(0, 2, 1, 3, 4)
    qr = qr.reshape(P * B, KVH, S * G, hd)
    kr = k.reshape(P * B, S, KVH, hd).transpose(1, 2)
    vr = v.reshape(P * B, S, KVH, hd).transpose(1, 2)
    vis = _visible(S, G, causal, prefix)
    out = torch.full_like(qr, float("nan"))
    for wr0, tiles in flash_schedule(S, G, warps, BN, causal,
                                     prefix).items():
        rows = slice(wr0, min(wr0 + 16, S * G))
        qw = qr[:, :, rows]
        n = qw.shape[2]
        m = torch.full((P * B, KVH, n), NEG_INF)
        l = torch.zeros((P * B, KVH, n))
        acc = torch.zeros((P * B, KVH, n, hd))
        for k0, full in tiles:
            cols = slice(k0, min(k0 + BN, S))
            s = tf32_matmul(qw, kr[:, :, cols].transpose(-1, -2), 3) * scale
            ok = torch.ones_like(vis[rows, cols]) if full else vis[rows, cols]
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + tf32_matmul(p, vr[:, :, cols], 3)
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)[..., None]
    out = out.reshape(P * B, KVH, S, G, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(P, B, S, H, hd)


@pytest.mark.parametrize("hd,G", [(64, 1), (64, 8), (256, 1), (256, 8)])
def test_3xtf32_flash_with_prefix_matches_plain(hd, G, one_thread):
    """#5 under the prefix-LM mask, emulated over its tiles (hd 64: 8
    warps of 64 keys; hd 256: 4 warps of 32 keys, paligemma's tile):
    within 2e-5 of the plain version and the reference's jnp prefix
    attention, at a prefix off the tile grid and one of whole tiles."""
    warps, BN = (8, 64) if hd <= 128 else (4, 32)
    S = 80
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(hd + G, S, G, 1,
                                                          hd))
    for prefix in (37, 64):
        got = emulated_flash_tiles(q, k, v, prefix=prefix, warps=warps,
                                   BN=BN)
        want = ref.flash_attention(q, k, v, causal=True, prefix_len=prefix)
        assert (got - want).abs().max().item() < 2e-5, prefix
        jwant = np.asarray(jblocks.flash_attention(
            jnp.asarray(q[0].numpy()), jnp.asarray(k[0].numpy()),
            jnp.asarray(v[0].numpy()), kind="prefix", prefix_len=prefix))
        assert np.abs(got[0].numpy() - jwant).max() < 2e-5


def test_flash_cost_counts_the_visible_pairs(one_thread):
    """``flash_attention.cost``'s pairs (and so ``Program.cost()`` and the
    bound) are the pairs the mask lets through."""
    for S in (1, 5, 64, 300):
        for prefix in (0, 1, 7, S, S + 3):
            assert visible_pairs(S, True, prefix) == \
                int(_visible(S, 1, True, prefix).sum())
        assert visible_pairs(S, False) == S * S
    q = torch.zeros(2, 3, 300, 8, 256)
    kv = torch.zeros(2, 3, 300, 1, 256)
    flops, nbytes = flash_cost(q, kv, kv, causal=True, prefix_len=256)
    assert flops == 4 * 2 * 3 * 8 * 256 * int(_visible(300, 1, True,
                                                       256).sum())
    assert nbytes == 4 * (2 * q.numel() + 2 * kv.numel())


# -- query rows split over blocks ----------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.sampled_from([1, 2, 4, 8]), st.integers(1, 8),
       st.sampled_from([1, 2, 8, 16, 32, 64]), st.sampled_from([64, 128, 256]),
       st.sampled_from([4, 2]))
def test_block_rows_cover_every_query_row_once(KVH, W, G, hd, itemsize):
    rows = W * G
    try:
        heads, row_blocks = split_walk.block_rows(KVH, rows, hd, 32, itemsize)
    except ValueError:
        assert hd > split_walk.MAX_ENTRIES
        return
    assert KVH % heads == 0 and (row_blocks == 1 or heads == 1)
    seen = set()
    for kvh0, h, row0, n in split_walk.row_ranges(heads, row_blocks, KVH,
                                                  rows):
        assert n >= 1
        assert n * hd <= split_walk.MAX_ENTRIES
        assert split_walk.smem_bytes(1, n, hd, 32, itemsize) \
            <= split_walk.MAX_SMEM
        for r in range(row0, row0 + n):
            key = (kvh0 + r // rows, r % rows)
            assert key not in seen
            seen.add(key)
    assert seen == {(h, r) for h in range(KVH) for r in range(rows)}
    if heads * rows * hd <= split_walk.MAX_ENTRIES:
        assert row_blocks == 1


def test_block_rows_at_qwen3_moe_verify_shape():
    # W 5 x G 16 x hd 128 = 10,240 entries: one kv head a block, its 80
    # rows in 3 blocks of 27, 27 and 26; the single-token walk (W = 1,
    # 2,048 entries) keeps whole kv heads
    assert split_walk.block_rows(4, 80, 128, 32, 4) == (1, 3)
    assert [r[2:] for r in split_walk.row_ranges(1, 3, 4, 80)[:3]] == [
        (0, 27), (27, 27), (54, 26)]
    plan, heads, row_blocks = split_walk.launch_plan(
        256, 16, 5, 16, 4, 1, 8, 128, 4, 132)
    assert (heads, row_blocks) == (1, 3)
    assert split_walk.launch_plan(256, 16, 1, 16, 4, 1, 8, 128, 4,
                                  132)[1:] == (1, 1)


def test_split_rows_walk_matches_plain():
    """The window walk of each row block alone (every query row outside
    the block NaN) gives the block's rows the plain version's values at a
    shape whose rows split: W 3, G 32, hd 64 (6,144 entries a kv head)."""
    B, W, H, KVH, hd, ps, n_pmax = 2, 3, 64, 2, 64, 8, 6
    args = _window_case(11, 1, B, W, H, KVH, hd, ps, n_pmax, [13, 30])
    q = args[0]
    G, rows = H // KVH, W * (H // KVH)
    heads, row_blocks = split_walk.block_rows(KVH, rows, hd, 32, 4)
    assert (heads, row_blocks) == (1, 2)
    want = ref.paged_decode_window_attention(*args)
    got = torch.full_like(want, float("nan"))
    for kvh0, _, row0, n in split_walk.row_ranges(heads, row_blocks, KVH,
                                                  rows):
        mine = torch.zeros((W, H), dtype=torch.bool)
        for r in range(row0, row0 + n):
            mine[r // G, kvh0 * G + r % G] = True
        qb = torch.where(mine[None, None, :, :, None], q, float("nan"))
        out = emulated_window(qb, *args[1:])
        got = torch.where(mine[None, None, :, :, None], out, got)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-6
