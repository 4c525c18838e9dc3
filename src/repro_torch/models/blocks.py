"""Core NN blocks over an explicit leading particle axis.

Counterpart of ``repro.models.blocks`` for the LM's serving paths (paged
decode, speculative verify, prefill, dense-cache decode) and the
full-sequence (training) attention: the reference's double-chunked flash
attention with its blockwise backward for the LM's causal layers, the
plain whole-sequence attention for the ViT's bidirectional ones. The
reference writes each block for one particle and vmaps it over the
ParticleStore's stacked axis; here every function takes the stacked form
directly: parameter leaves carry a leading particle axis ``P`` and
activations are ``(P, B, S, ...)``. Weights keep the reference's
``(d_in, d_out)`` layout, so a stacked matmul is one batched GEMM
``(P, N, d_in) @ (P, d_in, d_out)``.

Token-level inputs (tokens, positions, block tables, seq_lens, a dense
cache's slot positions) are shared by all particles and carry no ``P``
axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as _kops
from ..kernels import ref as _kref
from ..sharding.policy import maybe_shard


# --------------------------------------------------------------------------
# init (one particle; ``lead`` prepends axes such as the stacked n_units)
# --------------------------------------------------------------------------

def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               scale: float = 1.0, lead=()):
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    device=gen.device) * (scale / math.sqrt(d_in))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), device=gen.device)
    return p


def norm_init(kind: str, d: int, *, device, lead=()):
    p = {"scale": torch.ones(tuple(lead) + (d,), device=device)}
    if kind != "rms":
        p["bias"] = torch.zeros(tuple(lead) + (d,), device=device)
    return p


def attn_init(gen, cfg, lead=()):
    hd = cfg.hd
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd,
                         bias=cfg.qkv_bias, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, lead=lead),
    }


def mlp_init(gen, cfg, lead=(), d_ff=None):
    """An MLP of hidden width ``d_ff`` (default ``cfg.d_ff``; MoE's shared
    experts pass ``cfg.shared_d_ff``)."""
    d_ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": dense_init(gen, cfg.d_model, d_ff, lead=lead),
                "wg": dense_init(gen, cfg.d_model, d_ff, lead=lead),
                "wo": dense_init(gen, d_ff, cfg.d_model, lead=lead)}
    if cfg.act == "gelu":
        return {"w1": dense_init(gen, cfg.d_model, d_ff, bias=True,
                                 lead=lead),
                "w2": dense_init(gen, d_ff, cfg.d_model, bias=True,
                                 lead=lead)}
    raise NotImplementedError(f"the port runs swiglu and gelu MLPs, not "
                              f"{cfg.act}")


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _per_particle(v, x):
    """(P, d) vector broadcast against x of shape (P, ..., d)."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


def dense_apply(p, x):
    """x (P, ..., d_in) @ w (P, d_in, d_out) [+ b (P, d_out)]. The weight
    is widened (or narrowed) to the activation's dtype; an int8 serve pack
    ``{"q", "s"}`` (``core.precision.quantize_int8``) expands to ``q * s``
    in fp32 first, so a packed tree runs through the model as it is."""
    w = p["w"]
    if isinstance(w, dict):
        w = w["q"] * w["s"]
    w = w.to(x.dtype)
    P, d_in = x.shape[0], x.shape[-1]
    x3 = x.reshape(P, -1, d_in)
    if "b" in p:
        y = torch.baddbmm(p["b"].to(x.dtype)[:, None, :], x3, w)
    else:
        y = torch.bmm(x3, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def norm_apply(p, x, *, eps: float = 1e-6):
    """RMSNorm (or LayerNorm when the params carry a bias), in fp32."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * _per_particle(p["scale"], x) \
            + _per_particle(p["bias"], x)
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * _per_particle(p["scale"], x)
    return y.to(x.dtype)


def rope(x, positions, theta: float):
    """Half-split RoPE. x (P, B, S, H, hd); positions (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., :, None] * freq             # (..., S, half)
    ang = ang[..., :, None, :]                               # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_qkv(p, x, cfg, positions):
    """x (P, B, S, D) -> q (P, B, S, H, hd), k/v (P, B, S, KVH, hd)."""
    P, B, S, _ = x.shape
    hd = cfg.hd
    q = dense_apply(p["wq"], x).reshape(P, B, S, cfg.n_heads, hd)
    k = dense_apply(p["wk"], x).reshape(P, B, S, cfg.n_kv_heads, hd)
    v = dense_apply(p["wv"], x).reshape(P, B, S, cfg.n_kv_heads, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return (maybe_shard(q, "attn_heads"), maybe_shard(k, "attn_kv"),
            maybe_shard(v, "attn_kv"))


def kv_heads(t, cfg):
    """k or v (..., KVH, hd), or a pool or cache of them, cut to the kv
    heads a model position's q heads read: ``cfg.kv_window`` (set by
    ``models.tp`` when the model axis does not divide the kv-head count,
    so every position holds every kv head), else ``t`` itself. A cut is
    a contiguous copy: the attention kernels read their k / v contiguous
    past the particle axis (ROADMAP item 32 would read the window in
    place)."""
    w = getattr(cfg, "kv_window", None)
    if w is None or (w[0] == 0 and w[1] == t.shape[-2]):
        return t
    return t[..., w[0]:w[1], :].contiguous()


def attn_out(p, out, cfg):
    """The attention's output projection: out (P, B, S, H * hd) through
    ``wo``. A model position that shares its one q head with others
    (``models.tp``: ``cfg.wo_cols``) multiplies only its slice of the
    head's dims, which its ``wo`` rows are."""
    cols = getattr(cfg, "wo_cols", None)
    if cols is not None:
        out = out[..., cols[0]:cols[1]]
    return dense_apply(p["wo"], out)


def full_attention(q, k, v, *, causal: bool):
    """Whole-sequence attention for the training forward of the ViT
    encoder's bidirectional layers, differentiable by autograd: the plain
    version of the prefill kernel, and the plain version the chunked
    ``flash_attention`` is held against. q (P, B, S, H, hd); k, v
    (P, B, S, KVH, hd) -> (P, B, S, H, hd).

    The reference trains through its jnp flash attention with a custom
    VJP (``flash_attention`` here), which no Pallas kernel backs; the
    Pallas ``flash_attention`` is forward only, and its port
    (``kernels.ops.flash_attention``) runs the prefill."""
    return _kref.flash_attention(q, k, v, causal=causal)


# --------------------------------------------------------------------------
# flash attention (plain torch, double-chunked online softmax; the
# reference's jnp form, which no Pallas kernel backs)
# --------------------------------------------------------------------------

NEG_INF = -1e30


def _chunk_mask(kind: str, q_pos, k_pos, *, window: int = 0,
                prefix_len: int = 0):
    """q_pos (qc,), k_pos (kc,) -> bool (qc, kc) allowed."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    if kind == "bidir":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    causal = k <= q
    if kind == "causal":
        return causal
    if kind == "sliding":
        return causal & (k > q - window)
    if kind == "prefix":
        return causal | (k < prefix_len)
    raise ValueError(kind)


def _block_mask(kind, window, prefix_len, q_offset, qi, q_chunk, ki, k_chunk,
                device):
    """The mask of block (qi, ki): None when every pair is allowed, False
    when none is (a block the reference computes to exact zeros: its
    weights are exp(-1e30 - m) = 0, its correction 1, so leaving it out
    changes no bit), else the (qc, kc) bool mask. Decided on the block's
    position bounds, which are Python ints."""
    if kind == "bidir":
        return None
    q_lo = q_offset + qi * q_chunk
    q_hi = q_lo + q_chunk - 1
    k_lo, k_hi = ki * k_chunk, (ki + 1) * k_chunk - 1
    if kind == "causal" or kind == "prefix":
        pre = kind == "prefix"
        if k_hi <= q_lo or (pre and k_hi < prefix_len):
            return None
        if k_lo > q_hi and not (pre and k_lo < prefix_len):
            return False
    if kind == "sliding":
        if k_hi <= q_lo and k_lo > q_hi - window:
            return None
        if k_lo > q_hi or k_hi <= q_lo - window:
            return False
    q_pos = q_lo + torch.arange(q_chunk, device=device)
    k_pos = k_lo + torch.arange(k_chunk, device=device)
    return _chunk_mask(kind, q_pos, k_pos, window=window,
                       prefix_len=prefix_len)


def _fa_fwd_impl(q, k, v, kind, window, prefix_len, q_offset, softcap,
                 q_chunk, k_chunk):
    """Padded-shape flash forward over the folded particle and batch axis
    N = P * B. q (N, Sqp, KVH, G, hd); k, v (N, Skp, KVH, hd). Returns
    (out (N, Sqp, KVH, G, hd), L (N, KVH, G, Sqp)) with L the log-sum-exp
    of the score rows (the flash softmax stats). With ``softcap`` > 0 the
    scores are capped (``softcap * tanh(s / softcap)``) before the mask,
    as the reference's are."""
    N, Sqp, KVH, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nq, nk = Sqp // q_chunk, k.shape[1] // k_chunk
    out = torch.empty_like(q)
    L = torch.empty((N, KVH, G, Sqp), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qq = q[:, rows] * scale                      # (N, qc, KVH, G, hd)
        m = torch.full((N, KVH, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((N, KVH, G, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            mask = _block_mask(kind, window, prefix_len, q_offset, qi,
                               q_chunk, ki, k_chunk, q.device)
            if mask is False:
                continue
            cols = slice(ki * k_chunk, (ki + 1) * k_chunk)
            kk, vv = k[:, cols], v[:, cols]
            s = torch.einsum("bqngh,bknh->bngqk", qq, kk).float()
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))     # (N, KVH, G, qc)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bngqk,bknh->bngqh", p.to(vv.dtype), vv)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        lsafe = torch.clamp(l, min=1e-30)
        out[:, rows] = (acc / lsafe[..., None]).to(q.dtype).permute(
            0, 3, 1, 2, 4)
        L[..., rows] = m + torch.log(lsafe)
    return out, L


def _fa_bwd_impl(q, k, v, out, L, do, kind, window, prefix_len, q_offset,
                 softcap, q_chunk, k_chunk):
    """Blockwise flash backward: each block's scores are recomputed from
    q, k and L, so memory stays O(S * chunk); D = rowsum(do * out). Never
    taken with a softcap (``flash_attention`` differentiates the capped
    forward itself, as the reference does)."""
    assert softcap == 0.0
    N, Sqp, KVH, G, hd = q.shape
    Skp = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = Sqp // q_chunk, Skp // k_chunk
    D = (do.float() * out.float()).sum(-1)           # (N, Sqp, KVH, G)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros((N, Skp, KVH, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for qi in range(nq):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qq = q[:, rows].float()                      # (N, qc, KVH, G, hd)
        doo = do[:, rows].float()
        Li = L[..., rows]                            # (N, KVH, G, qc)
        Di = D[:, rows].permute(0, 2, 3, 1)          # (N, KVH, G, qc)
        dq_c = torch.zeros_like(qq)
        for ki in range(nk):
            mask = _block_mask(kind, window, prefix_len, q_offset, qi,
                               q_chunk, ki, k_chunk, q.device)
            if mask is False:
                continue
            cols = slice(ki * k_chunk, (ki + 1) * k_chunk)
            kk, vv = k[:, cols].float(), v[:, cols].float()
            s = torch.einsum("bqngh,bknh->bngqk", qq * scale, kk)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - Li[..., None])         # (N, KVH, G, qc, kc)
            dp = torch.einsum("bqngh,bknh->bngqk", doo, vv)
            ds = p * (dp - Di[..., None])
            dq_c = dq_c + torch.einsum("bngqk,bknh->bqngh", ds, kk) * scale
            dk[:, cols] += torch.einsum("bngqk,bqngh->bknh", ds, qq) * scale
            dv[:, cols] += torch.einsum("bngqk,bqngh->bknh", p, doo)
        dq[:, rows] = dq_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps (q, k, v, out,
    L), the backward recomputes every block (``_fa_bwd_impl``), so no
    (S, S) score block outlives its chunk."""

    @staticmethod
    def forward(ctx, q, k, v, statics):
        out, L = _fa_fwd_impl(q, k, v, *statics)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.statics = statics
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L = ctx.saved_tensors
        dq, dk, dv = _fa_bwd_impl(q, k, v, out, L, do.contiguous(),
                                  *ctx.statics)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    prefix_len: int = 0, softcap: float = 0.0,
                    q_chunk: int = 512, k_chunk: int = 1024):
    """q (P, B, Sq, H, hd); k, v (P, B, Sk, KVH, hd) -> (P, B, Sq, H, hd).

    The reference's training attention: GQA by head grouping, a
    double-chunked online softmax whose memory is O(Sq * k_chunk), never
    (Sq, Sk), and a custom backward that recomputes attention blockwise
    (``_FlashAttention``). The particle and batch axes fold into one
    (N = P * B), as the reference's vmap over particles sees each
    particle's batch. Its chunk defaults and padding rules: a chunk is
    at most the sequence, the sequence is padded up to whole chunks, and
    padded keys of a "bidir" attention are masked by a prefix mask over
    the real keys with the queries moved to negative positions. Blocks
    the mask empties entirely are skipped (exact: the reference's sums
    get zeros there). The kinds: "causal", "bidir" (Sk may differ from
    Sq: the decoder's cross-attention over the encoder's frames),
    "sliding" (key j visible to query i iff i - window < j <= i: gemma3's
    local layers) and "prefix" (key j visible to query i iff j <= i or
    j < ``prefix_len``: paligemma's bidirectional image prefix). With
    ``softcap`` > 0 only the forward is the flash form and autograd
    differentiates it, as the reference has no custom backward for a
    capped score."""
    if kind not in ("causal", "bidir", "sliding", "prefix"):
        raise ValueError(f"unknown flash attention kind {kind!r}")
    P, B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[2], k.shape[3]
    q_chunk = min(q_chunk, max(Sq, 1))
    k_chunk = min(k_chunk, max(Sk, 1))
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    pq, pk = nq * q_chunk - Sq, nk * k_chunk - Sk
    qf = q.reshape(P * B, Sq, KVH, H // KVH, hd)
    kf = k.reshape(P * B, Sk, KVH, hd)
    vf = v.reshape(P * B, Sk, KVH, hd)
    if pq:
        qf = F.pad(qf, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:      # padded keys are masked by position (causal: in the future)
        kf = F.pad(kf, (0, 0, 0, 0, 0, pk))
        vf = F.pad(vf, (0, 0, 0, 0, 0, pk))
    pad_kind, q_offset = kind, 0
    if kind != "prefix":
        prefix_len = 0
    if kind == "bidir" and pk:
        # every query sees exactly the keys [0, Sk): a prefix mask over
        # them, with the queries at negative positions so that its causal
        # branch never fires
        pad_kind, prefix_len = "prefix", Sk
        q_offset = -(nq * q_chunk + 1)
    statics = (pad_kind, window, prefix_len, q_offset, softcap, q_chunk,
               k_chunk)
    if softcap > 0.0:
        out = _fa_fwd_impl(qf, kf, vf, *statics)[0]
    else:
        out = _FlashAttention.apply(qf, kf, vf, statics)
    return out[:, :Sq].reshape(P, B, Sq, H, hd)


def paged_attention(q, k_pages, v_pages, *, block_tables, seq_lens,
                    use_kernel: bool = True):
    """Decode attention over a paged KV pool. q (P, B, H, hd); pages
    (P, NP, ps, KVH, hd). ``use_kernel=False`` takes the plain version on
    any device (parity checks); the kernel path is the serve hot spot."""
    if use_kernel:
        return _kops.paged_decode_attention(q, k_pages, v_pages,
                                            block_tables, seq_lens)
    return _kref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                        seq_lens)


def paged_write_index(block_tables, seq_lens, page_size: int, scratch: int):
    """(valid, page, slot) of this step's KV writes, one per row (B,).

    The reference scatters every row and lets the inactive ones drop as
    out of range (``mode="drop"``); torch has no dropping scatter, so an
    inactive row's write goes to slot 0 of the ``scratch`` page (one that
    no block table names: ``models.api.scratch_page``) and ``write_kv``
    keeps that slot's value there. Fixed shapes, no host sync: computed
    once per decode step and shared by every layer."""
    active = seq_lens >= 0
    pos = torch.where(active, seq_lens, 0).long()
    page = block_tables.gather(1, (pos // page_size)[:, None])[:, 0].long()
    return (active, torch.where(active, page, scratch), pos % page_size)


def write_kv(pages, k, v, write_index):
    """Write new K/V rows into the pool IN PLACE at ``write_index``'s
    (page, slot). ``k``/``v`` (P, *I, KVH, hd) for an index of shape I.
    A dropped write (``valid`` False, sent to the scratch page) stores
    the value already at its slot, so the scratch page never changes and
    the pool stays the reference's, scratch page included."""
    valid, page, slot = write_index
    keep = valid.reshape((1,) + tuple(valid.shape) + (1, 1))
    for pool, new in ((pages["k"], k), (pages["v"], v)):
        old = pool[:, page, slot]
        pool[:, page, slot] = torch.where(keep, new.to(pool.dtype), old)


def attn_apply_paged(p, x, cfg, pages, *, block_tables, seq_lens,
                     write_index, use_kernel: bool = True):
    """One continuous-batching decode step for one attention layer.

    x (P, B, 1, D); pages {"k", "v"}: (P, NP, ps, KVH, hd), updated IN
    PLACE (the reference donates the pool; here the step writes its one
    new K/V row per active sequence into the pool tensors themselves, so
    no pool of several GB is copied per step). seq_lens (B,) is the
    absolute position of the token in x; ``write_index``
    (``paged_write_index``) sends the writes of rows with seq_lens < 0 to
    the scratch page, and those rows return zeros. Returns (out
    (P, B, 1, D), pages)."""
    if cfg.logit_softcap > 0.0:
        raise NotImplementedError("paged decode does not support logit softcap")
    P, B = x.shape[:2]
    q, k, v = attn_qkv(p, x, cfg, seq_lens[:, None]
                       if cfg.rope_theta > 0 else None)
    write_kv(pages, k[:, :, 0], v[:, :, 0], write_index)
    kp, vp = kv_heads(pages["k"], cfg), kv_heads(pages["v"], cfg)
    out = paged_attention(q[:, :, 0], kp, vp, block_tables=block_tables,
                          seq_lens=seq_lens, use_kernel=use_kernel)
    return attn_out(p, out.reshape(P, B, 1, -1), cfg), pages


def window_write_index(block_tables, seq_lens, win_lens, W: int,
                       page_size: int, scratch: int):
    """(valid, page, slot) of a W-wide verify window's KV writes, each
    (B, W): position w of row b writes at ``seq_lens[b] + w`` when the row
    is active and ``w < win_lens[b]``; every other position goes to slot 0
    of the ``scratch`` page (``paged_write_index``). Computed once per
    verify call and shared by every layer."""
    w = torch.arange(W, device=seq_lens.device)
    valid = (seq_lens >= 0)[:, None] & (w[None, :] < win_lens[:, None])
    pos = torch.where(valid, seq_lens[:, None].long() + w, 0)
    page = block_tables.gather(1, pos // page_size).long()
    return valid, torch.where(valid, page, scratch), pos % page_size


def prefill_write_index(block_table_row, n_tokens, Sp: int, page_size: int,
                        scratch: int):
    """(valid, page, slot) of a padded prompt's KV writes, each (Sp,):
    position i writes at page ``block_table_row[i // page_size]`` when
    ``i < n_tokens`` (a device scalar or an int); padding positions go to
    slot ``i % page_size`` of the ``scratch`` page."""
    positions = torch.arange(Sp, device=block_table_row.device)
    valid = positions < n_tokens
    logical = (positions // page_size).clamp(max=block_table_row.shape[0] - 1)
    page = block_table_row[logical].long()
    return valid, torch.where(valid, page, scratch), positions % page_size


def attn_apply_window_paged(p, x, cfg, pages, *, block_tables, seq_lens,
                            write_index):
    """One speculative verify step (a drafted window) for one attention
    layer.

    x (P, B, W, D): token w of row b sits at absolute position
    ``seq_lens[b] + w``; ``write_index`` (``window_write_index``) names
    the real window positions. Their K/V rows go into the pool IN PLACE
    first, then the window attends through the window kernel, so query w
    sees drafts 0..w (causal within the window by position) and the whole
    committed prefix. Positions past a row's window length are neither
    written nor to be trusted; rows with seq_lens < 0 write nothing and
    return zeros. Returns (out (P, B, W, D), pages)."""
    if cfg.logit_softcap > 0.0:
        raise NotImplementedError("paged decode does not support logit softcap")
    P, B, W, _ = x.shape
    pos = seq_lens.clamp(min=0)[:, None] + torch.arange(W, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, pos if cfg.rope_theta > 0 else None)
    write_kv(pages, k, v, write_index)
    kp, vp = kv_heads(pages["k"], cfg), kv_heads(pages["v"], cfg)
    out = _kops.paged_decode_window_attention(q, kp, vp, block_tables,
                                              seq_lens)
    return attn_out(p, out.reshape(P, B, W, -1), cfg), pages


def attn_apply_prefill_paged(p, x, cfg, pages, *, write_index):
    """Prompt prefill for ONE sequence into the page pool.

    x (P, 1, Sp, D) prompt embeddings padded to a shape bucket. Causal
    attention over the padded prompt through the prefill kernel (the real
    positions never see the padding), then the K/V rows of the real
    positions go into the sequence's pages, in place, and the padding's
    to the scratch page (``write_index``, from ``prefill_write_index``).
    Returns (out (P, 1, Sp, D), pages)."""
    if cfg.logit_softcap > 0.0:
        raise NotImplementedError("paged decode does not support logit softcap")
    P, B, Sp, _ = x.shape
    positions = torch.arange(Sp, device=x.device)
    q, k, v = attn_qkv(p, x, cfg,
                       positions if cfg.rope_theta > 0 else None)
    out = _kops.flash_attention(q, kv_heads(k, cfg), kv_heads(v, cfg),
                                causal=True)
    out = attn_out(p, out.reshape(P, B, Sp, -1), cfg)
    write_kv(pages, k[:, 0], v[:, 0], write_index)
    return out, pages


def attn_apply_fullseq(p, x, cfg, *, kind: str = "causal", window: int = 0,
                       prefix_len: int = 0, cross_kv=None):
    """Full-sequence attention (training). x (P, B, S, D); positions
    ``arange(S)`` feed RoPE when the config has it (the ViT keeps the
    default theta, on top of its learned positions). ``kind`` "causal"
    (the LM's layers), "sliding" (``local`` layers, ``window`` keys) and
    "prefix" (the prefix-LM, keys below ``prefix_len`` visible to every
    query) run the chunked ``flash_attention`` with the config's softcap;
    "bidir" (the encoders' layers: the ViT's, whisper's) the plain
    ``full_attention``. ``cross_kv`` (k, v (P, B, F, KVH, hd), the
    encoder's) makes it cross-attention, as the reference's: q alone is
    projected and roped, the kind is "bidir" over the F keys, through the
    chunked ``flash_attention`` (Sk differs from Sq). Returns (P, B, S,
    D)."""
    P, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    rope_pos = positions if cfg.rope_theta > 0 else None
    if cross_kv is not None:
        q = dense_apply(p["wq"], x).reshape(P, B, S, cfg.n_heads, cfg.hd)
        if rope_pos is not None:
            q = rope(q, rope_pos, cfg.rope_theta)
        out = flash_attention(q, *(kv_heads(t, cfg) for t in cross_kv),
                              kind="bidir", softcap=cfg.logit_softcap)
        return attn_out(p, out.reshape(P, B, S, -1), cfg)
    q, k, v = attn_qkv(p, x, cfg, rope_pos)
    k, v = kv_heads(k, cfg), kv_heads(v, cfg)
    if kind != "bidir":
        out = flash_attention(q, k, v, kind=kind, window=window,
                              prefix_len=prefix_len,
                              softcap=cfg.logit_softcap)
    else:
        out = full_attention(q, k, v, causal=False)
    return attn_out(p, out.reshape(P, B, S, -1), cfg)


def attn_apply_encode(p, x, cfg):
    """Bidirectional self-attention of an encoder layer in serving (the
    prefill of whisper's frames): q, k, v roped as in training, through
    the prefill kernel with ``causal=False`` (Sq = Sk). x (P, B, S, D) ->
    (P, B, S, D)."""
    P, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, positions if cfg.rope_theta > 0 else None)
    out = _kops.flash_attention(q, kv_heads(k, cfg), kv_heads(v, cfg),
                                causal=False)
    return attn_out(p, out.reshape(P, B, S, -1), cfg)


def cross_kv(p, enc, cfg):
    """The cross-attention's k, v (P, B, F, KVH, hd) from the encoder's
    output enc (P, B, F, D): projected, never roped."""
    P, B, F_, _ = enc.shape
    shape = (P, B, F_, cfg.n_kv_heads, cfg.hd)
    return (dense_apply(p["wk"], enc).reshape(shape),
            dense_apply(p["wv"], enc).reshape(shape))


def cross_attn_decode(p, x, cfg, xk, xv):
    """One-token cross-attention over the encoder's cached k / v, as the
    reference's decode computes it: q (P, B, 1, D) projected with no rope
    (its prefill ropes q; its decode does not), every one of the F slots
    valid (``k_pos`` = arange(F) for every row), through the dense-decode
    kernel. xk, xv (P, B, F, KVH, hd). Returns (P, B, 1, D)."""
    P, B = x.shape[:2]
    F_ = xk.shape[2]
    q = dense_apply(p["wq"], x).reshape(P, B, cfg.n_heads, cfg.hd)
    k_pos = torch.arange(F_, dtype=torch.int32, device=x.device).repeat(B, 1)
    out = _kops.decode_attention(q, kv_heads(xk, cfg), kv_heads(xv, cfg),
                                 k_pos)
    return attn_out(p, out.reshape(P, B, 1, -1), cfg)


def attn_apply_decode(p, x, cfg, cache, *, cur_pos, window: int = 0):
    """One-token decode over a dense cache for one attention layer.

    x (P, B, 1, D), every row at absolute position ``cur_pos``, a 0-d
    int tensor on the device (``api.decode_step`` checks its range on the
    host); cache {"k", "v": (P, B, C, KVH, hd), "pos": (B, C) int32, the
    slot positions shared by the particles}. The new K/V row and its
    position are written at slot ``cur_pos`` IN PLACE (the reference
    returns a new cache), or at ``cur_pos % C`` for a ring cache
    (``window`` > 0: a ``local`` layer's C = min(window, max_len) slots,
    the oldest overwritten), then the token attends over the cache's
    filled slots through the dense-decode kernel; with a logit softcap,
    through the plain form (the reference's decode kernel has no
    softcap). Returns (out (P, B, 1, D), cache)."""
    P, B = x.shape[:2]
    C = cache["k"].shape[2]
    slot = (cur_pos % C if window else cur_pos).reshape(1).long()
    pos = cur_pos.reshape(1, 1).expand(B, 1)
    q, k, v = attn_qkv(p, x, cfg, pos if cfg.rope_theta > 0 else None)
    cache["k"].index_copy_(2, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slot, pos.to(torch.int32))
    args = (q[:, :, 0], kv_heads(cache["k"], cfg), kv_heads(cache["v"], cfg),
            cache["pos"])
    if cfg.logit_softcap > 0.0:
        out = _kref.decode_attention(*args, softcap=cfg.logit_softcap)
    else:
        out = _kops.decode_attention(*args)
    return attn_out(p, out.reshape(P, B, 1, -1), cfg), cache


def attn_apply_prefill(p, x, cfg, cache, *, window: int = 0,
                       prefix_len: int = 0):
    """Prefill of a whole prompt that fills the layer's empty dense decode
    cache. x (P, B, S, D); cache {"k", "v": (P, B, C, KVH, hd), "pos":
    (B, C)}. A global layer (``window`` 0) attends causally through the
    prefill kernel (with ``prefix_len`` > 0, under the prefix-LM mask:
    keys below it visible to every query), or, with a logit softcap,
    through the plain flash form (the kernel has no softcap); C >= S, and the prompt's K/V rows
    and positions 0..S-1 are written IN PLACE, the slots past S left
    empty (the decode headroom). A ``local`` layer attends through the
    plain sliding-window flash form (the reference's jnp one: no kernel
    computes a window) and fills its ring in the reference's layout: the
    entry for position p at slot p % C, so a prompt longer than the ring
    keeps its last C positions. Returns (out (P, B, S, D), cache)."""
    P, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, positions if cfg.rope_theta > 0 else None)
    kk, vv = kv_heads(k, cfg), kv_heads(v, cfg)
    if window or cfg.logit_softcap > 0.0:
        kind = "sliding" if window else "prefix" if prefix_len else "causal"
        out = flash_attention(q, kk, vv, kind=kind, window=window,
                              prefix_len=prefix_len,
                              softcap=cfg.logit_softcap)
    else:
        out = _kops.flash_attention(q, kk, vv, causal=True,
                                    prefix_len=prefix_len)
    out = attn_out(p, out.reshape(P, B, S, -1), cfg)
    C = cache["k"].shape[2]
    if window and S > C:
        kept = positions[S - C:]
        slot = kept % C
        cache["k"].index_copy_(2, slot, k[:, :, S - C:].to(cache["k"].dtype))
        cache["v"].index_copy_(2, slot, v[:, :, S - C:].to(cache["v"].dtype))
        cache["pos"].index_copy_(1, slot, kept.to(torch.int32).expand(B, C))
        return out, cache
    cache["k"][:, :, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :, :S] = v.to(cache["v"].dtype)
    cache["pos"][:, :S] = positions.to(torch.int32)
    return out, cache


def attn_cache_init(cfg, particles: int, batch: int, seq_len: int, *,
                    dtype, device, lead=(), window: int = 0):
    """An empty dense cache: k/v (P, *lead, B, C, KVH, hd) zeros, pos
    (*lead, B, C) int32 = -1 (shared by the particles); C = seq_len, or
    min(window, seq_len) for a ``local`` layer's ring."""
    C = min(window, seq_len) if window else seq_len
    shape = (particles,) + tuple(lead) + (batch, C, cfg.n_kv_heads,
                                          cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(tuple(lead) + (batch, C), -1,
                              dtype=torch.int32, device=device)}


def attn_pages_init(cfg, num_pages: int, page_size: int, *, dtype, device,
                    lead=()):
    shape = tuple(lead) + (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def mlp_apply(p, x, cfg):
    """SwiGLU, wo(silu(wg x) * wi x); or GELU, w2(gelu(w1 x)) with the
    tanh approximation ``jax.nn.gelu`` defaults to."""
    if "wi" in p:
        h = F.silu(dense_apply(p["wg"], x)) * dense_apply(p["wi"], x)
        return dense_apply(p["wo"], maybe_shard(h, "mlp_hidden"))
    h = F.gelu(dense_apply(p["w1"], x), approximate="tanh")
    return dense_apply(p["w2"], maybe_shard(h, "mlp_hidden"))
