"""Roofline of the dry run's rows on an NVIDIA H100 (counterpart of
``repro.launch.roofline``, whose constants are another chip's: none of
them carries over).

For each (arch x shape) on the single-pod mesh, the three terms of one
device's step, from the dry run's count (``launch.cost``):

  compute term     = FLOPs per device / the card's dense bf16 peak    [s]
  memory term      = bytes per device / the card's HBM bandwidth      [s]
  collective term  = collective bytes per device / NVLink, one way    [s]

A count on the card's published peaks, not a timing: a row says which
term would set the pace if the step ran at the peaks, and the FLOPs of
every dtype (fp32 elementwise work included) are put against the bf16
tensor peak, as the reference does. ``model_flops`` is the useful work
(6 N T for training, 2 N T for serving) over the mesh's positions; the
``useful_ratio`` is it over the counted FLOPs.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline \\
            --runs runs/dryrun_torch
        (a markdown table on stdout, and runs/roofline_torch.json)
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

# The card's constants, keyed by what `nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader` prints. NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part, at its full 700 W limit: 989 TFLOP/s dense bf16
# (1,979 is the 2:4-sparse rate), 3.35 TB/s of HBM3, and fourth-generation
# NVLink at 900 GB/s a GPU both ways together, 450 GB/s in one direction.
CARDS = {
    "NVIDIA H100 80GB HBM3, 700.00 W": {
        "peak_flops": 989e12,     # dense bf16 tensor-core FLOP/s
        "hbm_bw": 3.35e12,        # HBM3 bytes/s
        "link_bw": 450e9,         # NVLink bytes/s, one direction
    },
}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CHIPS = 256                   # the single-pod plan mesh: data 16 x model 16

_COUNT_CACHE = {}


def param_counts(arch: str):
    """(total_params, active_params) of one particle (MoE: top-k of the
    routed experts active), from the init traced on fake tensors."""
    if arch in _COUNT_CACHE:
        return _COUNT_CACHE[arch]
    from .. import configs
    from ..sharding import rules
    from .steps import _template
    cfg = configs.get(arch)
    total = active = 0
    for path, leaf in rules.named_leaves(_template(cfg)):
        n = leaf.numel()
        total += n
        if re.search(r"moe/(wi|wg|wo)$", path) and cfg.n_experts:
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    _COUNT_CACHE[arch] = (total, active)
    return total, active


def model_flops(rec, shapes, chips: int = CHIPS):
    """Useful FLOPs per device: 6 N_active T (train), 2 N_active T
    (prefill), 2 N_active B (decode), times the particles, over the
    mesh's ``chips`` positions."""
    _, active = param_counts(rec["arch"])
    shp = shapes[rec["shape"]]
    P = rec.get("particles", 1)
    if shp.kind == "train":
        f = 6 * active * shp.global_batch * shp.seq_len
    elif shp.kind == "prefill":
        f = 2 * active * shp.global_batch * shp.seq_len
    else:
        f = 2 * active * shp.global_batch
    return f * P / chips


def terms(flops: float, nbytes: float, coll: float, card: str = CARD):
    """(compute s, memory s, collective s, the dominant term's name) of
    one device's counts on ``card``'s peaks."""
    c = CARDS[card]
    t = {"compute": flops / c["peak_flops"], "memory": nbytes / c["hbm_bw"],
         "collective": coll / c["link_bw"]}
    return t["compute"], t["memory"], t["collective"], max(t, key=t.get)


def analyze(runs_dir: str, mesh: str = "single"):
    from ..configs import INPUT_SHAPES
    rows = []
    for f in sorted(glob.glob(os.path.join(runs_dir, f"*__{mesh}.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r["status"] != "ok":
            rows.append({**r, "dominant": "-"})
            continue
        card = r.get("card", CARD)
        coll = sum(r["collective_bytes_per_device"].values())
        t_c, t_m, t_n, dom = terms(r["flops_per_device"],
                                   r["bytes_per_device"], coll, card)
        mf = model_flops(r, INPUT_SHAPES, r.get("chips", CHIPS))
        mem = r.get("memory") or {}
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "status": "ok",
            "card": card, "particles": r["particles"], "mode": r["mode"],
            "flops_per_device": r["flops_per_device"],
            "bytes_per_device": r["bytes_per_device"],
            "collective_bytes_per_device": coll,
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n,
            "dominant": dom,
            "model_flops_per_device": mf,
            "useful_ratio": mf / max(r["flops_per_device"], 1.0),
            "hbm_args_gb": mem.get("argument_size_in_bytes", 0) / 1e9,
            "hbm_temp_gb": mem.get("temp_size_in_bytes", 0) / 1e9,
            "collectives_gb": {k: v / 1e9 for k, v in
                               r["collective_bytes_per_device"].items()},
        })
    return rows


NOTES = {
    "compute": "at the compute roofline: raise the tensor cores' share "
               "(fuse, wider tiles) or cut FLOPs (causal block pruning, "
               "less remat recompute)",
    "memory": "HBM-bound: raise arithmetic intensity (fuse elementwise "
              "chains, bf16 activations, fewer copies)",
    "collective": "NVLink-bound: cut transfers between positions (a "
                  "smaller model axis, overlap with compute)",
}


def markdown(rows):
    out = ["| arch | shape | P | mode | GFLOP/dev | GB/dev | coll GB/dev | "
           "HBM args+temp GB | compute s | memory s | collective s | "
           "dominant | useful FLOP ratio | note |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            why = r.get("reason") or r.get("error", "")
            item = re.search(r"item \w+", why)
            why = f"{item.group(0)}: {why[:60]}" if item else why[:90]
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - | "
                       f"- | - | - | - | {r.get('status')} | - | {why} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['particles']} | {r['mode']} "
            f"| {r['flops_per_device'] / 1e9:.1f} "
            f"| {r['bytes_per_device'] / 1e9:.2f} "
            f"| {r['collective_bytes_per_device'] / 1e9:.2f} "
            f"| {r['hbm_args_gb'] + r['hbm_temp_gb']:.2f} "
            f"| {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} "
            f"| {r['t_collective_s']:.4f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {NOTES[r['dominant']]} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="runs/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default="runs/roofline_torch.json")
    a = ap.parse_args()
    rows = analyze(a.runs, a.mesh)
    print(f"Counts on the published peaks of {CARD} (not a timing).")
    print(markdown(rows))
    os.makedirs(os.path.dirname(a.json_out) or ".", exist_ok=True)
    with open(a.json_out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
