"""Dry run: trace every (arch x input shape x mesh) at data position 0 of
the production mesh on fake tensors and count one device's step
(counterpart of ``repro.launch.dryrun``).

The reference compiles against 512 placeholder host devices and reads
the compiled program. The port traces the steps the card runs
(``launch.steps.build``) eagerly on fake tensors, which need no card and
no memory, and counts them (``launch.cost``; a stack of more than two
units is counted from traces at 1 and 2 units, ``cost.extrapolate``).
Only data position 0's model group is traced: every data position runs
the same shapes.

A record keeps the reference's keys that ``roofline.analyze`` reads
(``status``, ``particles``, ``mode``, ``microbatches``, ``param_dtype``,
``flops_per_device``, ``bytes_per_device``,
``collective_bytes_per_device``, ``memory``) and adds ``trace_s`` (the
trace's wall time on the host), ``kv_layout`` (the port places caches by
kv head) and ``card`` (whose constants the roofline reads). The
reference's ``lower_s`` / ``compile_s``, ``raw_*`` and
``generated_code_size_in_bytes`` have no counterpart: there is no
compile. A failing combination is recorded with its error and the sweep
goes on.

Usage:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
            --mesh single [--out runs/dryrun_torch] [--bdl svgd]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .. import configs as configs_mod
from ..configs import INPUT_SHAPES
from . import cost as cost_mod
from .mesh import make_production_mesh
from .plans import plan_for
from .roofline import CARD


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            verbose: bool = True, bdl: str = "ensemble"):
    cfg = configs_mod.get(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    skip = configs_mod.is_skipped(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    plan = plan_for(cfg, shape)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "bdl": bdl, "mesh": mesh_name,
           "particles": plan.particles, "mode": plan.mode,
           "microbatches": plan.microbatches, "param_dtype": plan.param_dtype,
           "kv_layout": "heads", "card": CARD}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec["chips"] = mesh.size
        c, placement = cost_mod.count(cfg, shape, plan, mesh, bdl)
        rec.update({
            "units_traced": "all" if cfg.n_units <= 2
            else "1 and 2, extrapolated",
            "status": "ok", "trace_s": round(time.time() - t0, 1),
            "local_particles": placement["particles"],
            "local_batch": placement["batch"],
            "flops_per_device": c["flops"],
            "bytes_per_device": c["bytes"],
            "collective_bytes_per_device": c["coll"],
            "memory": c["memory"],
            "top_collectives": cost_mod.top_collectives(c, 6),
        })
        if verbose:
            mem = c["memory"]
            coll = {k: f"{v / 1e9:.2f}GB" for k, v in c["coll"].items()}
            print(f"[{arch} x {shape_name} x {mesh_name}] OK "
                  f"trace={rec['trace_s']:.0f}s "
                  f"flops/dev={c['flops']:.3e} bytes/dev={c['bytes']:.3e} "
                  f"coll={coll} "
                  f"args={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
                  f"temp={mem['temp_size_in_bytes'] / 1e9:.2f}GB")
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec.update({"status": "fail", "trace_s": round(time.time() - t0, 1),
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAIL: "
                  f"{type(e).__name__}: {str(e)[:300]}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--bdl", default="ensemble",
                    choices=["ensemble", "svgd", "multiswag"])
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = sorted(configs_mod.ARCHS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.bdl != "ensemble":
                    tag += f"__{args.bdl}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[{tag}] exists, skipping")
                    continue
                rec = run_one(arch, shape, mp, bdl=args.bdl)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"sweep_s={time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
