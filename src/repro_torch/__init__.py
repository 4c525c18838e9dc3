"""PyTorch + CUDA port of the Push particle runtime (``repro``).

Mirrors the subpackage and module names of the JAX package ``repro``, so
each counterpart sits at the same path. It imports ``torch`` and numpy,
never ``jax`` and nothing from ``repro``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
