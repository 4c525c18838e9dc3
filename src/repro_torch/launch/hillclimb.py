"""Hillclimb: the three roofline terms of one (arch x shape) with
optional plan overrides, and the top collectives by site (counterpart of
``repro.launch.hillclimb``). Like the reference's ``measure``, which
compiles and does not run, this traces on fake tensors and runs nothing:
a count on the card's published peaks (``launch.roofline``), no timing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3-8b \\
      --shape decode_32k [--microbatches 8] [--particles 32] \\
      [--top-collectives] [--bdl svgd]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from .. import configs as configs_mod
from ..configs import INPUT_SHAPES
from . import cost as cost_mod
from .mesh import make_production_mesh
from .plans import plan_for
from .roofline import CARD, terms


def measure(arch: str, shape_name: str, *, microbatches=None, particles=None,
            top: bool = False, multi_pod: bool = False,
            bdl: str = "ensemble"):
    cfg = configs_mod.get(arch)
    shape = INPUT_SHAPES[shape_name]
    plan = plan_for(cfg, shape)
    if microbatches is not None:
        plan = dataclasses.replace(plan, microbatches=microbatches)
    if particles is not None:
        plan = dataclasses.replace(plan, particles=particles)
    mesh = make_production_mesh(multi_pod=multi_pod)
    c, _ = cost_mod.count(cfg, shape, plan, mesh, bdl)
    coll = sum(c["coll"].values())
    t_c, t_m, t_n, dom = terms(c["flops"], c["bytes"], coll)
    mem = c["memory"]
    rec = {
        "arch": arch, "shape": shape_name, "card": CARD,
        "plan": dataclasses.asdict(plan),
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n,
        "dominant": dom,
        "coll_gb": {k: round(v / 1e9, 3) for k, v in c["coll"].items()},
        "hbm_temp_gb": mem["temp_size_in_bytes"] / 1e9,
        "hbm_args_gb": mem["argument_size_in_bytes"] / 1e9,
        "trace_s": c["trace_s"],
    }
    print(json.dumps({k: v for k, v in rec.items() if k != "plan"},
                     indent=1))
    if top:
        print("top collectives (bytes x calls):")
        for kind, tot, calls, each, site in cost_mod.top_collectives(c):
            print(f"  {kind:18s} {tot / 1e9:9.3f}GB x{calls:6d} "
                  f"each {each / 1e6:9.2f}MB  {site[:80]}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--top-collectives", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--bdl", default="ensemble")
    a = ap.parse_args(argv)
    measure(a.arch, a.shape, microbatches=a.microbatches,
            particles=a.particles, top=a.top_collectives,
            multi_pod=a.multi_pod, bdl=a.bdl)


if __name__ == "__main__":
    main()
