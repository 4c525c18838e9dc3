"""Mixed-precision policy for particle ensembles (counterpart of
``repro.core.precision``, DESIGN.md §13).

One frozen ``Precision`` value is threaded from model and infer configs
through the store, the runtime and serving:

  master_dtype   what the ``ParticleStore`` holds as the canonical stacked
                 trees (params + optimizer state). fp32 by default; a
                 pure-bf16 store halves params + optimizer bytes.
  compute_dtype  what the train steps compute in. When it differs from the
                 master dtype, the step casts the masters (and the batch's
                 floating leaves) inside its body, the gradients come back
                 in the masters' dtype (autograd through the cast) and the
                 optimizer updates the masters.
  serve_dtype    what serving forwards in (defaults to compute_dtype). A
                 store-backed engine keeps a serve copy of the stacked
                 params, rewritten in place by a ``serve_cast`` program
                 once per store commit (``serve.engine``).
  serve_quant    ``"int8"`` further packs large weight leaves per output
                 channel for the BMA forward; the predict program
                 dequantizes them at its top.
  kv_dtype       storage dtype of the paged KV pools; None defers to the
                 model config's cache dtype.

The policy is identity for program caching: every spec built under a
policy that casts carries ``Precision.key()`` in its ``ProgramSpec``,
which ``runtime.cache.ProgramCache`` folds into the cache key; the fp32
specs carry None. Dtype names are the reference's strings ("float32",
"bfloat16"), so ``key()`` and ``describe()`` equal the reference's.

The remat menu (``CHECKPOINT_POLICIES``, ``checkpoint_policy``) names
what the LM training stack's checkpointed units keep for the backward
(``models.transformer.stack_apply_full``, its one caller).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .tree import tree_leaves, tree_map

__all__ = ["Precision", "PRESETS", "get", "cast_floats", "tree_bytes",
           "quantize_int8", "dequantize", "is_quantized_leaf",
           "cast_for_serve", "serve_copy_like", "cast_for_serve_into",
           "quantize_int8_like", "quantize_int8_into",
           "CHECKPOINT_POLICIES", "checkpoint_policy"]


def _torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dtype_name(dt) -> str:
    """"float32", "bfloat16", ...: the name numpy and JAX print."""
    return str(_torch_dtype(dt)).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Precision:
    """Master / compute / serve dtype split for one particle ensemble."""

    master_dtype: str = "float32"
    compute_dtype: str = "float32"
    serve_dtype: Optional[str] = None      # None -> compute_dtype
    serve_quant: Optional[str] = None      # None | "int8"
    kv_dtype: Optional[str] = None         # None -> model cache default

    def __post_init__(self):
        _torch_dtype(self.master_dtype)     # fail fast on typos
        _torch_dtype(self.compute_dtype)
        if self.serve_dtype is not None:
            _torch_dtype(self.serve_dtype)
        if self.kv_dtype is not None:
            _torch_dtype(self.kv_dtype)
        if self.serve_quant not in (None, "int8"):
            raise ValueError(
                f"serve_quant must be None or 'int8', got {self.serve_quant!r}")

    # -- resolved dtypes -----------------------------------------------------
    @property
    def master(self) -> torch.dtype:
        return _torch_dtype(self.master_dtype)

    @property
    def compute(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    @property
    def serve(self) -> torch.dtype:
        return _torch_dtype(self.serve_dtype or self.compute_dtype)

    @property
    def kv(self) -> Optional[torch.dtype]:
        return None if self.kv_dtype is None else _torch_dtype(self.kv_dtype)

    @property
    def casts_compute(self) -> bool:
        """True iff train steps compute on a cast copy of the masters."""
        return self.compute != self.master

    @property
    def casts_serve(self) -> bool:
        """True iff serving needs a transformed (cast / quantized) copy."""
        return self.serve != self.master or self.serve_quant is not None

    def key(self) -> tuple:
        """Hashable identity for ProgramSpec / ProgramCache keys."""
        return (dtype_name(self.master), dtype_name(self.compute),
                dtype_name(self.serve), self.serve_quant, self.kv_dtype)

    def describe(self) -> dict:
        return {"master": dtype_name(self.master),
                "compute": dtype_name(self.compute),
                "serve": dtype_name(self.serve),
                "serve_quant": self.serve_quant, "kv": self.kv_dtype}


#: The precision ladder. ``fp32`` is the default (the programs of the
#: pre-policy code); ``mixed`` keeps fp32 masters and computes in bf16;
#: ``bf16`` stores bf16 masters; ``mixed_int8`` adds per-channel int8
#: weight packs for the BMA serve path.
PRESETS = {
    "fp32": Precision(),
    "mixed": Precision(compute_dtype="bfloat16"),
    "bf16": Precision(master_dtype="bfloat16", compute_dtype="bfloat16"),
    "mixed_int8": Precision(compute_dtype="bfloat16", serve_quant="int8"),
}


def get(p: Any = None) -> Precision:
    """Resolve ``None`` | preset name | ``Precision`` to a ``Precision``."""
    if p is None:
        return PRESETS["fp32"]
    if isinstance(p, Precision):
        return p
    if isinstance(p, str):
        try:
            return PRESETS[p]
        except KeyError:
            raise ValueError(
                f"unknown precision preset {p!r}; "
                f"options: {sorted(PRESETS)}") from None
    raise TypeError(f"precision must be None, str or Precision, got {type(p)}")


# ---------------------------------------------------------------------------
# tree casts
# ---------------------------------------------------------------------------

def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_floats(tree, dtype):
    """Cast every floating tensor leaf of ``tree`` to ``dtype``; anything
    else (ints, bools, non-tensors) passes through untouched, and so does
    a leaf that already has ``dtype`` (the same tensor, no copy). Under
    autograd the cast is differentiable: the gradient of a cast leaf comes
    back in the leaf's own dtype."""
    dtype = _torch_dtype(dtype)
    return tree_map(lambda x: x.to(dtype)
                    if _is_float(x) and x.dtype != dtype else x, tree)


def tree_bytes(tree, precision: Any = None) -> int:
    """Policy-aware per-particle byte estimate: floating leaves counted at
    the policy's *master* itemsize, others at their own. Takes tensors of
    any device (meta and fake tensors included)."""
    fsize = torch.finfo(get(precision).master).bits // 8
    total = 0
    for leaf in tree_leaves(tree):
        n = leaf.numel()
        total += n * (fsize if leaf.is_floating_point()
                      else leaf.element_size())
    return total


# ---------------------------------------------------------------------------
# int8 per-channel weight quantization (serve side, BMA forward)
# ---------------------------------------------------------------------------

_QKEYS = frozenset(("q", "s"))


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == _QKEYS


def _quantizes(w, min_ndim: int) -> bool:
    return _is_float(w) and w.dim() >= min_ndim


def _quant(w, q, s):
    """Write the int8 pack of one leaf into ``q`` (int8) and ``s`` (fp32),
    the reference's arithmetic: one scale per (particle, output channel),
    reduced over every axis between them (with a stacked ``n_units`` axis,
    one scale spans every unit), a round-half-to-even of ``w / s`` in
    fp32. One full-size fp32 temporary: max |w| is the larger of max w and
    -min w, and the rounding and clamping run in place."""
    wf = w.float()
    axes = tuple(range(1, wf.dim() - 1))
    amax = torch.maximum(wf.amax(dim=axes, keepdim=True),
                         -wf.amin(dim=axes, keepdim=True))
    scale = amax.clamp(min=1e-8) / 127.0
    q.copy_((wf / scale).round_().clamp_(-127, 127))
    s.copy_(scale)


def quantize_int8(tree, *, min_ndim: int = 3):
    """Per-output-channel symmetric int8 quantization of a *stacked* param
    tree (leading particle axis). Floating leaves with ``ndim >=
    min_ndim`` (matmul weights (P, [n_units,] d_in, d_out), embeddings
    (P, V, D), and the stacked units' (P, n_units, d) biases and norm
    scales) become ``{"q": int8, "s": fp32 scale}``, the scale reduced
    over every axis except the particle axis (0) and the last, with
    keepdims so that it broadcasts back. Smaller leaves are copied, left
    for the plain dtype cast."""
    return quantize_int8_into(quantize_int8_like(tree, min_ndim=min_ndim),
                              tree)


def _dequant(x, dtype):
    """``q * s`` (int8 times fp32 is one fp32 product), cast to ``dtype``."""
    return (x["q"] * x["s"]).to(dtype)


def _map_packed(fn, tree, *rest):
    """``tree_map`` that treats ``{"q", "s"}`` packs as leaves."""
    if is_quantized_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_packed(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_packed(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def dequantize(tree, dtype):
    """Inverse of :func:`quantize_int8`: ``{"q", "s"}`` packs expand to
    ``q * s`` in fp32, then cast to ``dtype``; every other leaf goes
    through :func:`cast_floats`'s rule (a leaf already in ``dtype`` is
    returned as it is)."""
    dtype = _torch_dtype(dtype)

    def dq(x):
        if is_quantized_leaf(x):
            return _dequant(x, dtype)
        return x.to(dtype) if _is_float(x) and x.dtype != dtype else x

    return _map_packed(dq, tree)


def cast_for_serve(tree, precision: Any):
    """The serve copy of a stacked master tree under a policy:
    ``serve_quant="int8"`` packs the large weight leaves to ``{"q", "s"}``
    (scales stay fp32) and casts the rest to the serve dtype; otherwise a
    plain float cast. A leaf the policy leaves as it is is the master's
    own tensor. A new tree; ``cast_for_serve_into`` writes the same values
    into an existing copy."""
    return cast_for_serve_into(serve_copy_like(tree, precision), tree)


def serve_copy_like(tree, precision: Any):
    """An uninitialized serve copy of ``tree`` (the structure, shapes and
    dtypes that ``cast_for_serve`` gives), on the leaves' devices. A leaf
    that the policy leaves as it is (not floating, or already in the serve
    dtype and not packed) is the master's own tensor: nothing to copy."""
    prec = get(precision)
    quant = prec.serve_quant == "int8"

    def like(x):
        if quant and _quantizes(x, 3):
            return _pack_like(x)
        if _is_float(x) and x.dtype != prec.serve:
            return torch.empty(x.shape, dtype=prec.serve, device=x.device)
        return x

    return tree_map(like, tree)


def cast_for_serve_into(out, tree):
    """Write ``cast_for_serve(tree, precision)`` into ``out``, a
    ``serve_copy_like(tree, precision)`` tree, in place and return
    ``out``: the body of the engine's ``serve_cast`` program, whose copy
    keeps its addresses across store commits. A pack's int8 values are
    integral, so ``copy_`` into ``q`` is exact; a float leaf's ``copy_``
    rounds as ``.to`` does."""
    def write(x, o):
        if is_quantized_leaf(o):
            _quant(x, o["q"], o["s"])
        elif o is not x:
            o.copy_(x)
        return o

    tree_map(write, tree, out)
    return out


def _pack_like(x):
    s_shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return {"q": torch.empty(x.shape, dtype=torch.int8, device=x.device),
            "s": torch.empty(s_shape, dtype=torch.float32, device=x.device)}


def quantize_int8_like(tree, *, min_ndim: int = 3):
    """Uninitialized buffers with the structure, shapes and dtypes of
    ``quantize_int8(tree)``, every leaf a buffer of its own (none is a
    leaf of ``tree``)."""
    return tree_map(lambda x: _pack_like(x) if _quantizes(x, min_ndim)
                    else torch.empty_like(x), tree)


def quantize_int8_into(pack, tree, row=None, take=None, dtype=None):
    """Write ``quantize_int8(tree)`` into ``pack`` (a
    ``quantize_int8_like`` tree) in place and, when ``row`` is given (a
    tree of tensors at ``tree``'s structure), ``dequantize(pack, dtype)``
    into ``row`` too: the values rounded to ``dtype`` (default: each row
    leaf's own), held in the row leaf's dtype. A row wider than ``dtype``
    holds them exactly, so a model that widens its weights to its
    activations' dtype computes the same from it, without widening.
    ``take(leaf)`` (default: the leaf) selects what is packed of each
    leaf, one leaf at a time, so that only one leaf's temporaries live at
    once. Returns ``pack``."""
    def write(x, pk, r=None):
        x = x if take is None else take(x)
        if is_quantized_leaf(pk):
            _quant(x, pk["q"], pk["s"])
            if r is not None:
                r.copy_(_dequant(pk, dtype or r.dtype))
        else:
            pk.copy_(x)
            if r is not None:
                r.copy_(x.to(dtype or r.dtype))
        return pk

    if row is None:
        tree_map(write, tree, pack)
    else:
        tree_map(write, tree, pack, row)
    return pack


# ---------------------------------------------------------------------------
# named checkpoint policies (the reference's remat menu)
# ---------------------------------------------------------------------------

# the product ops: every dense of the port is a bmm (or a baddbmm with its
# bias) over the particle axis
_DOTS = frozenset(("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the products, recompute the rest.
    An ``autograd.Function``'s forward runs without grad, and its backward
    never reads those products (the chunked flash attention recomputes its
    score blocks itself; no reference policy sees inside its custom VJP),
    so they are not kept either."""
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "overloadpacket", op).__name__
    if name in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(body, context_fn=None):
    """``body`` under a non-reentrant checkpoint that saves no RNG state:
    the models draw no random numbers, and a captured step must not read
    the generator's state."""
    from torch.utils.checkpoint import checkpoint
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if context_fn is not None:
        kw["context_fn"] = context_fn
    return lambda *args: checkpoint(body, *args, **kw)


def _keep_everything(body):
    return body


def _keep_nothing(body):
    return _checkpointed(body)


def _keep_dots(body):
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return _checkpointed(
        body, lambda: create_selective_checkpoint_contexts(_save_dots))


CHECKPOINT_POLICIES = {
    "everything_saveable": _keep_everything,
    "nothing_saveable": _keep_nothing,
    "dots_saveable": _keep_dots,
    "dots_with_no_batch_dims": _keep_dots,
    "dots_with_no_batch_dims_saveable": _keep_dots,
}


def checkpoint_policy(name: str):
    """Named rematerialization policy: a function ``body -> body`` that
    wraps a unit's forward as the policy says, on ``torch.utils.checkpoint``.

    ``nothing_saveable`` is a plain checkpoint (every op recomputed in the
    backward: the least activation memory), ``everything_saveable`` no
    checkpoint (every output autograd needs is kept), ``dots_saveable`` a
    selective checkpoint that keeps the outputs of the product ops (aten
    ``mm``, ``bmm``, ``addmm``, ``baddbmm``) and recomputes the rest.
    ``dots_with_no_batch_dims`` (and its ``_saveable`` spelling) keeps the
    same ops: the reference's policy sees one particle's dots inside its
    vmap, where every dense is a dot with no batch dimension, and the
    port's denses are those dots batched over the particle axis. No policy
    keeps the products inside the chunked flash attention (``_save_dots``).
    A policy changes memory and recompute, never values."""
    try:
        return CHECKPOINT_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown checkpoint policy {name!r}; "
            f"options: {sorted(CHECKPOINT_POLICIES)}") from None
