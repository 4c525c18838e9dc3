"""Launch tooling (counterpart of ``repro.launch``): the device mesh of
the particle axis."""
from .mesh import Mesh, make_bench_mesh, make_mesh, pick_model_axis

__all__ = ["Mesh", "make_bench_mesh", "make_mesh", "pick_model_axis"]
