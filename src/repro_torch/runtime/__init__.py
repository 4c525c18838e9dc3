"""repro_torch.runtime: the plan/capture/execute layer (counterpart of
``repro.runtime``, DESIGN.md §8).

program.py   -- ProgramSpec / BuildCtx / Program; ``lower`` captures a
                step as a CUDA graph on the card and runs it eagerly on
                the CPU; ShardedProgram runs a step per mesh position
cache.py     -- ProgramCache (hits, misses, captures); global_cache()
specs.py     -- the steps as ProgramSpecs: the ensemble train step and
                predict, map_step (the SWAG collection), the serving steps
backends.py  -- the Runtime protocol, NelRuntime / CompiledRuntime
bucketing.py -- power-of-two bucketing shared with serve/
"""
from . import specs
from .backends import (BACKENDS, CompiledRuntime, NelRuntime, Runtime,
                       make_runtime)
from .bucketing import bucket_size, pad_rows
from .cache import ProgramCache, global_cache
from .program import (BuildCtx, Program, ProgramSpec, ShardedProgram,
                      abstract_key, arg_key, capture, eager, ident, lower)

__all__ = ["BACKENDS", "BuildCtx", "CompiledRuntime", "NelRuntime",
           "Program", "ProgramCache", "ProgramSpec", "Runtime",
           "ShardedProgram", "abstract_key",
           "arg_key", "bucket_size", "capture", "eager", "global_cache",
           "ident", "lower", "make_runtime", "pad_rows", "specs"]
