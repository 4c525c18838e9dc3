"""The split KV walk of the three decode-attention kernels: its plan, fixed
on the host, and the scratch its partials need.

``csrc/split_walk.cuh`` is the device side, shared by the single-token
paged kernel (``paged_decode_attention``), the drafted-window kernel
(``paged_decode_window_attention``) and the dense-cache kernel
(``decode_attention``). A row of keys is ``n_pmax`` units of ``ps``
columns: pages, or single slots of a dense cache (``ps`` 1, ``n_pmax``
C). Each row's walk is split across blocks and the splits' partials
merge in split order.

``split_plan`` fixes the split count and a floor of units per split from
``n_pmax``, ``ps``, ``W`` and the size of the grid alone: the host never
reads ``seq_lens`` or ``k_pos``, which would cost a device sync a call. ``split_ranges`` is the
rule by which the kernel gives each split its units once it reads a
row's ``seq_len``; ``stage_ranges`` the stages a split walks.
``dense_plan`` is the plan of a dense row of C slots, which the kernel
walks as if every row's last query sat at C - 1.

A block takes ``heads`` kv heads of one (row, particle, split) and all
their W * G query rows, while those rows' accumulators fit a block
(``MAX_ENTRIES``). A kv head whose rows do not fit (qwen3-moe's verify:
W 5 x G 16 x hd 128 = 10,240 entries) has its query rows split over
``row_blocks`` blocks of one kv head each (``block_rows``); each block
walks the same columns for its own rows (``row_ranges``), and a row's
arithmetic is the same in any of them.
"""
from __future__ import annotations

import functools

import torch

STAGE_COLS = 32        # columns a block stages at a time (about)
MAX_SPLITS = 8         # splits per (kv head, row, particle)
MAX_ENTRIES = 4096     # heads * W * G * hd: accumulator entries of a block
WARPS = 4              # warps of a block (csrc/split_walk.cuh kThreads / 32)
BLOCK_SMEM = 80 * 1024  # a grouped block's shared memory: 2+ blocks an SM
MAX_SMEM = 232448      # shared memory a Hopper block may use, in bytes


def split_plan(n_pmax: int, ps: int, W: int, stage_cols: int = STAGE_COLS,
               max_splits: int = MAX_SPLITS, *, blocks: int = 0, sms: int = 0):
    """(units per stage, floor of units per split, number of splits).

    A stage holds about ``stage_cols`` columns; a split holds at least one
    stage and one whole window, and there are at most ``max_splits`` of
    them, fewer when ``n_pmax`` units fill fewer floors. When the unsplit
    grid already has ``blocks`` >= ``sms`` blocks (one per SM or more), a
    row is not split: on the H100 the splits and their merge then cost
    more than they win (PERF.md)."""
    stage = max(1, stage_cols // ps)
    floor = max(stage, -(-W // ps))
    if blocks >= sms > 0:
        return stage, floor, 1
    return stage, floor, max(1, min(max_splits, -(-n_pmax // floor)))


def dense_plan(C: int, stage_cols: int = STAGE_COLS,
               max_splits: int = MAX_SPLITS, **grid):
    """The plan over a dense row of ``C`` slots (units of one column)."""
    return split_plan(C, 1, 1, stage_cols, max_splits, **grid)


def split_ranges(plan, seq_len: int, W: int, ps: int, n_pmax: int):
    """The units [start, stop) that each split of a row reads (the kernel's
    rule): a row with ``n_live`` live units gives each split
    ``max(floor, ceil(n_live / n_splits))`` of them in order; splits past
    the live units, and every split of an inactive row, get none."""
    _, floor, n_splits = plan
    if seq_len < 0:
        return [(0, 0)] * n_splits
    n_live = min((seq_len + W - 1) // ps + 1, n_pmax)
    per = max(floor, -(-n_live // n_splits))
    return [(min(s * per, n_live), min((s + 1) * per, n_live))
            for s in range(n_splits)]


def stage_ranges(plan, start: int, stop: int):
    """The stages [a, z) of units that a split owning [start, stop) walks;
    the last one may be short."""
    return [(a, min(a + plan[0], stop)) for a in range(start, stop, plan[0])]


def smem_bytes(heads: int, rows: int, hd: int, cols: int,
               itemsize: int) -> int:
    """Dynamic shared memory of a block (``launch`` in split_walk.cuh):
    two stages of ``cols`` padded K and V rows per kv head, then q, the
    weights and the row statistics in fp32, and the columns' flags."""
    pad = -(-hd // 32) * 32 + 4 if itemsize == 4 else -(-hd // 64) * 64 + 8
    R = heads * rows
    return (itemsize * 4 * heads * cols * pad + 4 * (R * hd + R * cols + 3 * R)
            + 4 * 2 * cols)


def _fits(heads, KVH, rows, hd, cols, itemsize):
    return (KVH % heads == 0 and heads * rows * hd <= MAX_ENTRIES
            and smem_bytes(heads, rows, hd, cols, itemsize) <= MAX_SMEM)


def block_rows(KVH: int, rows: int, hd: int, cols: int,
               itemsize: int):
    """(kv heads a block takes, blocks a kv head's ``rows`` query rows are
    split over): ``heads_per_block`` kv heads and 1 while one kv head's
    rows fit a block; else one kv head, its rows in the fewest blocks of
    at most ``MAX_ENTRIES / hd`` rows that fit ``MAX_SMEM``. Raises if
    not even one row fits."""
    if _fits(1, KVH, rows, hd, cols, itemsize):
        return heads_per_block(KVH, rows, hd, cols, itemsize), 1
    for n in range(2, rows + 1):
        per = -(-rows // n)
        if per * hd <= MAX_ENTRIES and \
                smem_bytes(1, per, hd, cols, itemsize) <= MAX_SMEM:
            return 1, -(-rows // per)
    raise ValueError(f"no block fits one query row of hd {hd} with {cols} "
                     f"columns a stage")


def row_ranges(heads: int, row_blocks: int, KVH: int, rows: int):
    """(first kv head, kv heads, first row, rows) of each block along the
    grid's x axis, the kernel's rule: block x takes kv heads ``(x //
    row_blocks) * heads`` on and the rows ``[row0, row0 + n)`` of their
    ``heads * rows`` query rows, ``row0 = (x % row_blocks) * per`` with
    ``per = ceil(heads * rows / row_blocks)``."""
    per = -(-heads * rows // row_blocks)
    out = []
    for x in range(KVH // heads * row_blocks):
        row0 = (x % row_blocks) * per
        out.append(((x // row_blocks) * heads, heads, row0,
                    max(0, min(per, heads * rows - row0))))
    return out


def heads_per_block(KVH: int, rows: int, hd: int, cols: int,
                    itemsize: int) -> int:
    """Kv heads a block takes: as many as give each warp at most one query
    row (``rows`` = W * G of them per kv head), dividing ``KVH``, within
    ``BLOCK_SMEM`` of shared memory (``cols`` columns a stage of
    ``itemsize``-byte K/V): at hd 64 two with fp32 pages, four with bf16
    (PERF.md: one, two and four on the H100; four fp32 kv heads need
    141 KB, one block an SM, and lose). Raises if one does not fit."""
    if not _fits(1, KVH, rows, hd, cols, itemsize):
        raise ValueError(f"a block of one kv head does not fit: {rows} "
                         f"query rows a head, hd {hd}, {cols} columns a "
                         f"stage")
    heads = 1
    while (2 * heads * rows <= WARPS
           and smem_bytes(2 * heads, rows, hd, cols, itemsize) <= BLOCK_SMEM
           and _fits(2 * heads, KVH, rows, hd, cols, itemsize)):
        heads *= 2
    return heads


@functools.lru_cache(maxsize=16)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once a device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def launch_plan(n_pmax: int, ps: int, W: int, G: int, KVH: int, P: int,
                B: int, hd: int, itemsize: int, sms: int):
    """(plan, kv heads a block, row blocks a kv head) of one launch over P
    particles and B rows: the blocks' rows by ``block_rows``, then the
    plan for the grid of P * B * (KVH / heads) * row_blocks (row,
    particle, kv head group, row block) blocks."""
    stage = split_plan(n_pmax, ps, W)[0]
    heads, row_blocks = block_rows(KVH, W * G, hd, stage * ps, itemsize)
    return split_plan(n_pmax, ps, W,
                      blocks=P * B * KVH // heads * row_blocks,
                      sms=sms), heads, row_blocks


def scratch(plan, P: int, B: int, KVH: int, rows: int, hd: int, device):
    """fp32 partials (m, l, acc) of every split: ``rows`` query rows per kv
    head; one element when the plan has one split (no partials)."""
    n_splits = plan[2]
    n = P * B * KVH * n_splits * rows * (hd + 2) if n_splits > 1 else 1
    return torch.empty(n, dtype=torch.float32, device=device)
