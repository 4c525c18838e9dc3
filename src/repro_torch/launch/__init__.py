"""Launch tooling (counterpart of ``repro.launch``): the device mesh of
the particle axis, the run plans, and the dry run's steps, count,
roofline and hillclimb (``steps``, ``cost``, ``roofline``, ``dryrun``,
``hillclimb``; imported by name)."""
from . import plans
from .mesh import (Mesh, make_bench_mesh, make_mesh, make_production_mesh,
                   pick_model_axis)
from .plans import RunPlan, plan_for

__all__ = ["Mesh", "RunPlan", "make_bench_mesh", "make_mesh",
           "make_production_mesh", "pick_model_axis", "plan_for", "plans"]
