#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port (src/repro_torch) runs on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 0  builds every CUDA kernel under src/repro_torch/kernels/csrc from
         the checkout (one nvcc per source, all started together).
Phase 1  holds each kernel against its plain PyTorch version on the card:
         the tests/test_paged.py sweep with a particle axis of 2 and NaN in
         every stale slot, plus the qwen1.5-0.5b serving shape, with fp32
         and bf16 pages, both within 1e-4 (the two sides widen the same
         bf16 values and accumulate in fp32); inactive rows must be exact
         zeros. Then it times, at the serving shape with the L2 cache
         flushed before each call: the kernel, its plain version, and one
         scaled_dot_product_attention call on K/V gathered beforehand
         (library_ms, a yardstick the port never calls).
Phase 2  drives serve_decode over P=4 full-width qwen1.5-0.5b particles
         (24 layers, random weights from seed 0) with 8 mixed-length
         requests (prompts of 16-128 tokens, max_new 16-64). Every request
         must finish with finite heads, and the kernel's launch count over
         the driven run must be 24 per decode step. Then one decode step on
         freshly prefilled rows runs through the kernel and through the
         plain version; their BMA mean probabilities must agree within
         1e-4 of the largest probability, their member logits within 1e-3.

Output: one JSON object per line (phase results, then the kernels line), the
card's name and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Exits non-zero without that last line when
there is no CUDA device, when run outside a checkout of the repository, or
when any phase fails.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
PARTICLES = 4
PAGE_SIZE = 16
NUM_PAGES = 256
MAX_ACTIVE = 8
N_REQUESTS = 8
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SWEEP = [
    (2, 4, 2, 32, 16, 4, [47, 63]),
    (3, 8, 1, 16, 8, 6, [0, 33, 21]),
    (2, 4, 4, 8, 16, 3, [-1, 40]),
    (4, 6, 3, 64, 32, 2, [5, -1, 63, 31]),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg, code=1):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def paged_case(torch, seed, P, B, H, KVH, hd, ps, n_pmax, NP, lens, dtype):
    """Random q/pages with the PagePool conventions; NaN in the tail slots
    of each row's last page and in every page no row owns."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((P, B, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
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
    dead = sorted(set(range(NP)) - owned)
    k[:, dead] = float("nan")
    v[:, dead] = float("nan")
    dev = torch.device("cuda")
    return (q.to(dev), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_kernel(torch, kernel, ref, args, lens, tol, what):
    out = kernel(*args)
    torch.cuda.synchronize()
    want = ref(*args)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output (NaN leaked)")
    err = float((out.float() - want.float()).abs().max())
    if not err < tol:
        raise AssertionError(f"{what}: max abs err {err} >= {tol}")
    for b, L in enumerate(lens):
        if L < 0 and float(out[:, b].abs().max()) != 0.0:
            raise AssertionError(f"{what}: inactive row {b} is not zero")
    return err


def time_ms(torch, fn, iters=30):
    """Median device time of one call, with the 50 MB L2 flushed before
    each call (a decode step streams other layers' weights in between)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def traffic(vocab):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(1, vocab, int(rng.integers(16, 129))).tolist(),
             int(rng.integers(16, 65))) for _ in range(N_REQUESTS)]


def phase1(torch, cfg, reqs):
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import ref
    kernel = pk.paged_decode_attention
    errs = {"sweep_fp32": 0.0, "sweep_bf16": 0.0}
    for i, (B, H, KVH, hd, ps, n_pmax, lens) in enumerate(SWEEP):
        for dtype, tol, key in ((torch.float32, 1e-4, "sweep_fp32"),
                                (torch.bfloat16, 1e-4, "sweep_bf16")):
            args = paged_case(torch, 100 + i, 2, B, H, KVH, hd, ps, n_pmax,
                              B * n_pmax + 2, lens, dtype)
            errs[key] = max(errs[key], check_kernel(
                torch, kernel, ref.paged_decode_attention, args, lens, tol,
                f"sweep case {i} {dtype}"))
    # the serving shape: P particles, MAX_ACTIVE rows mid-generation
    P, H, KVH, hd = PARTICLES, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_pmax = NUM_PAGES
    lens = [len(p) + m // 2 for p, m in reqs][:MAX_ACTIVE]
    serve_args = {}
    for dtype, tol, key in ((torch.float32, 1e-4, "serve_fp32"),
                            (torch.bfloat16, 1e-4, "serve_bf16")):
        args = paged_case(torch, 7, P, len(lens), H, KVH, hd, PAGE_SIZE,
                          n_pmax, NUM_PAGES, lens, dtype)
        errs[key] = check_kernel(torch, kernel, ref.paged_decode_attention,
                                 args, lens, tol, f"serving shape {dtype}")
        serve_args[dtype] = args
    q, k, v, bt, sl = serve_args[torch.float32]
    ms = time_ms(torch, lambda: kernel(q, k, v, bt, sl))
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention(q, k, v, bt, sl))
    # library yardstick: one SDPA over K/V gathered to dense beforehand
    B, Lmax = len(lens), max(lens) + 1
    idx = torch.arange(Lmax, device="cuda")
    page = bt.long()[:, idx // PAGE_SIZE]                       # (B, Lmax)
    kd = k[:, page, idx % PAGE_SIZE].permute(0, 1, 3, 2, 4)     # (P,B,KVH,L,hd)
    vd = v[:, page, idx % PAGE_SIZE].permute(0, 1, 3, 2, 4)
    # stale slots hold NaN, which an additive mask would not hide
    kd = kd.reshape(P * B, KVH, Lmax, hd).nan_to_num().contiguous()
    vd = vd.reshape(P * B, KVH, Lmax, hd).nan_to_num().contiguous()
    qd = q.reshape(P * B, H, 1, hd)
    valid = (idx[None, :] <= sl[:, None].long())                # (B, Lmax)
    mask = valid[None].expand(P, B, Lmax).reshape(P * B, 1, 1, Lmax)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask))
    # bound: each live K/V row read once, q read and out written once
    live = sum(L + 1 for L in lens)
    n_bt = sum(L // PAGE_SIZE + 1 for L in lens)
    nbytes = (P * live * KVH * hd * 2 * 4 + 2 * q.numel() * 4
              + 4 * (n_bt + B))
    flops = 4 * P * live * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    emit({"phase": 1, "max_abs_err": errs, "serve_shape": {
        "P": P, "B": B, "H": H, "KVH": KVH, "hd": hd, "page_size": PAGE_SIZE,
        "n_pmax": n_pmax, "seq_lens": lens, "bytes": nbytes, "flops": flops}})
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:184",
            "max_abs_err": errs["serve_fp32"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def decode_parity(torch, pd, cfg, reqs, n_pmax):
    """One decode step on freshly prefilled rows, kernel vs plain version."""
    from repro_torch.models import api
    from repro_torch.runtime import bucket_size
    from repro_torch.serve import uncertainty
    store = pd.store
    params, mask = store.stacked("params"), store.active_mask()
    pages = store.checkout("kv_pages")
    try:
        B = len(reqs)
        bt = torch.zeros((B, n_pmax), dtype=torch.int32, device="cuda")
        tokens, seq_lens, nxt = [], [], 0
        for b, (prompt, _) in enumerate(reqs):
            n = len(prompt)
            need = n // PAGE_SIZE + 1          # covers the decode write at n
            bt[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
            nxt += need
            toks = torch.zeros((1, bucket_size(n)), dtype=torch.int32,
                               device="cuda")
            toks[0, :n] = torch.tensor(prompt, dtype=torch.int32)
            logits, _ = api.prefill_paged(params, toks, pages, bt[b], n, cfg)
            mean = uncertainty.predictive_heads(logits, mask=mask)["mean"]
            tokens.append(int(mean.argmax(-1)[0]))
            seq_lens.append(n)
        tok = torch.tensor(tokens, dtype=torch.int32, device="cuda")
        sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
        out = {}
        for use_kernel in (True, False):
            logits, _ = api.decode_step_paged(params, tok, pages, bt, sl, cfg,
                                              decode_kernel=use_kernel)
            out[use_kernel] = (logits, uncertainty.predictive_heads(
                logits, mask=mask)["mean"])
        profile = profile_steps(torch, lambda: uncertainty.predictive_heads(
            api.decode_step_paged(params, tok, pages, bt, sl, cfg)[0],
            mask=mask))
    finally:
        store.commit("kv_pages", pages)
    d_logits = float((out[True][0] - out[False][0]).abs().max())
    d_probs = float((out[True][1] - out[False][1]).abs().max())
    p_max = float(out[False][1].max())
    if not (d_logits < 1e-3 and d_probs <= 1e-4 * p_max):
        raise AssertionError(f"kernel vs plain decode step: logits "
                             f"{d_logits}, mean probs {d_probs} (max p "
                             f"{p_max})")
    return {"max_abs_logits": d_logits, "max_abs_mean_probs": d_probs,
            "max_mean_prob": p_max}, profile


def profile_steps(torch, step, n=5):
    """Host-clock time of one decode step over MAX_ACTIVE live rows (model
    + BMA heads, synchronised as the scheduler's heads copy is), then the
    device's busy time per step by kernel name from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
            torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            per_kernel[e.key] = us / n / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n, "rows": MAX_ACTIVE, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms else "not measured",
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
            "kernels": len(per_kernel),
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def phase2(torch, cfg, reqs):
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.models import api
    from repro_torch.serve import serve_decode
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    t0 = time.perf_counter()
    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(PARTICLES):
            pd.p_create()
        pd.store.stacked("params")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        svc = serve_decode(pd, cfg, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                           max_active=MAX_ACTIVE)
        try:
            pk.paged_decode_attention.launches = 0
            t1 = time.perf_counter()
            handles = [svc.generate_async(p, max_new=m) for p, m in reqs]
            gens = [h.result(600) for h in handles]
            wall = time.perf_counter() - t1
            launches = pk.paged_decode_attention.launches
            st = svc.stats()
        finally:
            svc.close()
        for g, (p, m) in zip(gens, reqs):
            if len(g.tokens) != m or g.finish_reason != "length":
                raise AssertionError(f"request did not finish: "
                                     f"{len(g.tokens)}/{m} tokens")
            heads = np.array([g.logprobs, g.entropy, g.mutual_info])
            if not np.isfinite(heads).all():
                raise AssertionError("non-finite heads")
        if launches != cfg.n_layers * st["steps"] or st["steps"] == 0:
            raise AssertionError(f"kernel launches {launches} != "
                                 f"{cfg.n_layers} x {st['steps']} steps")
        parity, profile = decode_parity(torch, pd, cfg, reqs,
                                        svc.engine.n_pmax)
        toks = sum(len(g.tokens) for g in gens)
        emit({"phase": 2, "model": cfg.name, "particles": PARTICLES,
              "layers": cfg.n_layers, "requests": len(gens),
              "generated_tokens": toks, "wall_s": wall,
              "tok_per_s": toks / wall, "steps": st["steps"],
              "prefills": st["prefills"], "ms_per_step_wall": wall / st["steps"] * 1e3,
              "peak_pages": st["pool"]["peak_used"],
              "row_occupancy": st["row_occupancy"],
              "latency_p50_ms": st["latency_p50_ms"],
              "latency_p95_ms": st["latency_p95_ms"],
              "kernel_launches": launches, "init_s": t_init,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              "decode_parity": parity, "step_profile": profile})
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)

    from repro_torch import configs
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {n: sorted({ln.split(":", 1)[-1].strip()
                        for ln in build.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln})
             for n in build.sources()}
    emit({"phase": 0, "built": build.sources(),
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})

    cfg = configs.get("qwen1.5-0.5b")
    reqs = traffic(cfg.vocab_size)
    row = phase1(torch, cfg, reqs)
    row["launches"] = phase2(torch, cfg, reqs)
    emit({"kernels": [row]})
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
