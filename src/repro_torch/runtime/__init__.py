"""Step builders over the explicit particle axis and shape bucketing.

The reference compiles each step once through its ProgramCache; the port
runs eagerly, so a step is a plain function and there is no cache yet
(CUDA graphs are later work)."""
from .bucketing import bucket_size, pad_rows

__all__ = ["bucket_size", "pad_rows"]
