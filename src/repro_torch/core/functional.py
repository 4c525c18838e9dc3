"""Functional view of a Push distribution over the stacked particle axis
(counterpart of ``repro.core.functional``).

Params of all particles live in one tree with a leading particle axis;
every particle-local computation runs over that axis at once (the model
functions take it explicitly), and the all-to-all of SVGD is the stacked
``(n, D)`` matrix itself.

Elastic stores: stacked trees are capacity-padded and ``mask`` is the
store's ``(capacity,)`` active mask. Every masked op uses ``where`` (not
multiply) so garbage in dead slots — even NaN — never leaks into live
results.
"""
from __future__ import annotations

from typing import Callable

import torch

from .precision import cast_floats
from .tree import Group, tree_flatten, tree_leaves, tree_map


def init_stacked(module, n: int, generator):
    """n independent inits from ``generator`` (drawn in order, as a PD's
    particles are), stacked on a leading particle axis."""
    return stack_pytrees([module.init(generator) for _ in range(n)])


def stack_pytrees(trees):
    """Trees of one structure -> one tree of stacked leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_pytree(stacked, n: int):
    """The first ``n`` rows of a stacked tree, one tree (of views) each."""
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def flatten_stacked(stacked, values: bool = True):
    """(tree with leading n) -> ((n, D) matrix, unravel).

    Columns follow ``jax.flatten_util.ravel_pytree``: leaves in sorted
    dict-key order, each raveled row-major. ``unravel`` maps an (n, D)
    matrix back to the stacked tree (the reference unravels one particle
    and vmaps); its leaves are views of the matrix. ``values=False``
    skips the matrix (None) and gives ``unravel`` alone."""
    leaves, unflatten = tree_flatten(stacked, sort_keys=True)
    n = leaves[0].shape[0]
    shapes = [tuple(x.shape[1:]) for x in leaves]
    sizes = [x[0].numel() for x in leaves]
    flat = (torch.cat([x.reshape(n, -1) for x in leaves], dim=1)
            if values else None)

    def unravel(mat):
        parts = mat.split(sizes, dim=1)
        return unflatten([p.reshape((mat.shape[0],) + s)
                          for p, s in zip(parts, shapes)])

    return flat, unravel


def flatten_into(stacked, out):
    """``flatten_stacked(stacked)``'s matrix written into ``out`` in
    place (cast to its dtype)."""
    leaves = tree_flatten(stacked, sort_keys=True)[0]
    n = leaves[0].shape[0]
    parts = [x.reshape(n, -1) for x in leaves]
    if all(x.dtype == out.dtype for x in parts):
        torch.cat(parts, dim=1, out=out)
    else:
        out.copy_(torch.cat(parts, dim=1))
    return out


def flatten_rows(trees):
    """[one particle's tree, ...] -> ((n, D) matrix, unravel): row i is
    tree i raveled in ``flatten_stacked``'s column order, written into
    one matrix (the NEL's SVGD leader gathers views this way).
    ``unravel`` maps one (D,) row back to a tree of views of it."""
    first, unflatten = tree_flatten(trees[0], sort_keys=True)
    shapes = [tuple(x.shape) for x in first]
    sizes = [x.numel() for x in first]
    out = first[0].new_empty((len(trees), sum(sizes)))
    for row, tree in zip(out, trees):
        torch.cat([x.reshape(-1) for x in
                   tree_flatten(tree, sort_keys=True)[0]], out=row)

    def unravel(row):
        return unflatten([p.reshape(s) for p, s in
                          zip(row.split(sizes), shapes)])

    return out, unravel


def expand_mask(mask, ndim: int):
    """(P,) mask broadcast-shaped against a (P, ...) tensor of `ndim`."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def masked_select(mask, new_tree, old_tree):
    """Per-slot select, out of place: live slots take ``new``, dead slots
    keep ``old`` (the frozen padding row)."""
    return tree_map(lambda nw, od: torch.where(
        expand_mask(mask, nw.dim()) > 0, nw, od), new_tree, old_tree)


def masked_assign(mask, new_tree, dst_tree):
    """Write ``new_tree`` into ``dst_tree`` in place; with a mask, live
    slots take `new` and dead slots keep their row bit for bit (the frozen
    padding row): the update rule of every masked train step. ``None``
    mask: every slot is live."""
    def write(dst, nw):
        if mask is None:
            return dst.copy_(nw)
        return torch.where(expand_mask(mask, dst.dim()) > 0, nw, dst,
                           out=dst)

    tree_map(write, dst_tree, new_tree)     # leaves matched by key path
    return dst_tree


def masked_mean(tree, mask):
    """Mean over the leading particle axis restricted to live slots."""
    live = mask.float().sum().clamp(min=1.0)
    return tree_map(lambda o: torch.where(expand_mask(mask, o.dim()) > 0,
                                          o, 0.0).sum(0) / live, tree)


def ensemble_value_and_grad(loss_fn: Callable, compute_dtype=None):
    """``f(stacked_params, batch) -> (losses (P,), grads)``: every
    particle sees the same batch.

    ``loss_fn(stacked_params, batch) -> (losses (P,), metrics)`` runs the
    forward over the explicit particle axis; one backward of
    ``losses.sum()`` then gives each particle's gradient. Particles share
    no parameters, so d(sum)/d(theta_i) = d(loss_i)/d(theta_i): this is
    the reference's ``vmap(value_and_grad)``.

    ``compute_dtype`` is the master/compute split (``core.precision``):
    the forward and backward run on a cast of the params and of the
    batch's floating leaves; autograd through the cast hands each
    gradient back in its master's dtype (the compute-dtype gradient,
    widened: the reference's ``g.astype(p.dtype)``), and the losses come
    back in fp32.

    Over a model group (``core.tree.Group``, a 2D placement) the loss
    runs tensor-parallel (``models.tp``) and the gradient comes back as a
    Group: split leaves per shard, replicated leaves summed over their
    copies (``models.tp.group_grads``)."""
    from ..models import tp

    def f(stacked_params, batch):
        group = isinstance(stacked_params, Group)
        leaves, unflatten = tree_flatten(stacked_params)
        with torch.enable_grad():
            req = [x.detach().requires_grad_(True) for x in leaves]
            params = unflatten(req)
            if compute_dtype is not None:
                params = cast_floats(params, compute_dtype)
                batch = cast_floats(batch, compute_dtype)
            losses, _ = loss_fn(tp.entry(params), batch)
            grads = torch.autograd.grad(losses.sum(), req,
                                        allow_unused=group)
        if compute_dtype is not None:
            losses = losses.float()
        if not group:
            return losses.detach(), unflatten(list(grads))
        per, at = [], 0
        for s in stacked_params.shards:
            n = len(tree_leaves(s))
            per.append(list(grads[at:at + n]))
            at += n
        return losses.detach(), tp.group_grads(stacked_params, per)

    return f


def ensemble_step(loss_fn: Callable, optimizer, compute_dtype=None):
    """One train step for all particles: grads + optimizer update, written
    into the caller's param and optimizer-state leaves in place (a
    captured step replays on fixed addresses).

    ``mask=None`` is the dense form; with a (capacity,) active mask, dead
    slots keep their params/opt state bit-for-bit (frozen padding rows)
    and report loss 0.0. Returns ``(stacked_params, stacked_opt_state,
    losses)``, the first two the caller's own trees. ``compute_dtype``:
    the grads come from ``ensemble_value_and_grad``'s cast, and the
    optimizer updates the masters in their own dtype."""
    from ..models import tp
    vag = ensemble_value_and_grad(loss_fn, compute_dtype)

    def step(stacked_params, stacked_opt_state, batch, mask=None):
        if optimizer.name == "adafactor" and tp.has_split(stacked_params):
            raise NotImplementedError(
                "adafactor factors each weight's second moment over the whole "
                "leaf; a model shard's row and column means are not the "
                "leaf's: train with adam or sgd on a model axis")
        losses, grads = vag(stacked_params, batch)
        for p, g, s, mk in per_shard(stacked_params, grads,
                                     stacked_opt_state, mask):
            new_p, new_s = optimizer.update(p, g, s)
            masked_assign(mk, new_p, p)
            masked_assign(mk, new_s, s)
        if mask is not None:
            losses = torch.where(mask > 0, losses, 0.0)
        return stacked_params, stacked_opt_state, losses

    return step


def per_shard(*trees):
    """(tree, ..., mask) per model position: the shards of Group trees
    side by side, with the last argument (a mask, or None) on each
    position's device; plain trees give one such tuple. An elementwise
    update (an optimizer's, SVGD's, a SWAG collection) runs on each
    shard as it is, so a replicated leaf's copies stay bit-equal."""
    *trees, mask = trees
    if not isinstance(trees[0], Group):
        return [tuple(trees) + (mask,)]
    devices = trees[0].devices
    return [tuple(t.shards[j] for t in trees)
            + (None if mask is None else mask.to(d),)
            for j, d in enumerate(devices)]


def ensemble_predict(forward: Callable):
    """hat f(x) = (1/n) sum_i nn_{theta_i}(x); with a mask, the BMA
    averages live slots only. ``forward(stacked_params, batch)`` returns
    member outputs with the particle axis leading."""

    from ..models import tp

    def f(stacked_params, batch, mask=None):
        with torch.no_grad():
            outs = forward(tp.entry(stacked_params), batch)
        if mask is None:
            return tree_map(lambda o: o.mean(0), outs)
        return masked_mean(outs, mask)

    return f
