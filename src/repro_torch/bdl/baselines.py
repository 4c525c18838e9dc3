"""Handwritten (non-particle) baselines, as compared against in paper §5.1
(counterpart of ``repro.bdl.baselines``).

These are the "baseline implementations" of Fig. 4: single-process,
sequential-over-networks, no particle abstraction. The SVGD baseline
materializes the full kernel matrix and updates all parameters only after
the kernel matrix is computed, keeping one copy of each NN (paper §5.1).

Not to be confused with ``backend="compiled"``: the compiled backend is
fused (one step over a stacked particle axis); these baselines are
deliberately sequential Python loops, the curves the particle runtime is
measured against.

Each NN's train step, grad and SWAG collection is a ``ProgramSpec``
through the process-wide ``ProgramCache`` (a CUDA graph on the card, the
eager body on the CPU), so its hits, misses and captures show in the same
stats as the particle paths'. A graph is bound to the addresses it was
captured on, so every NN gets its own program, captured on its own
tensors (as one-row views) and looked up once per run; the reference's
one program per module would here cost a copy of each NN's state into
and out of one program's static state every step, which is not the
baseline's math. SVGD's kernel update is one program over the stacked
``(n, D)`` matrices, which each step fills and unravels again.
"""
from __future__ import annotations

import torch

from ..core import functional
from ..core.tree import to_device, tree_flatten, tree_map
from ..runtime.cache import global_cache
from ..runtime.program import ProgramSpec, ident
from .svgd import svgd_force
from .swag import swag_collect, swag_state_init


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _inits(module, n: int, seed: int, device):
    """n NNs from one generator seeded ``seed`` on ``device``, drawn in
    order, as a ``PushDistribution(seed=seed)`` creates its particles."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [module.init(gen) for _ in range(n)]


def _row(tree):
    """One NN's tree as a one-row stacked view (no copy): the form the
    module's stacked loss and the step bodies take."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


def _program(spec, *args):
    return global_cache().program(spec, args)


def _sgd_step_spec(module, optimizer) -> ProgramSpec:
    """One NN's train step, ``(params, opt_state, batch) -> (params,
    opt_state, loss (1,))``, the state updated in place."""
    return ProgramSpec(
        name="baseline_sgd_step",
        key=("baseline_sgd_step", ident(module), ident(optimizer)),
        make=lambda ctx: functional.ensemble_step(module.loss, optimizer),
        in_kinds=("state", "state", "replicated"),
        out_kinds=("in:0", "in:1", "vector"))


def _grad_spec(module) -> ProgramSpec:
    """One NN's gradient, ``(params, batch) -> (grads,)``."""
    vag = functional.ensemble_value_and_grad(module.loss)
    return ProgramSpec(
        name="baseline_grad", key=("baseline_grad", ident(module)),
        make=lambda ctx: lambda p, b: (vag(p, b)[1],),
        in_kinds=("state", "replicated"), out_kinds=("replicated",))


def _kernel_update_spec(lr: float, lengthscale: float) -> ProgramSpec:
    """theta <- theta - lr * svgd_force(theta, g, ell) over the stacked
    ``(n, D)`` matrices, in place (the kernels #1 and #2 on the card)."""
    def make(ctx):
        def upd(theta, g):
            return (theta.sub_(lr * svgd_force(theta, g, lengthscale)),)
        return upd

    return ProgramSpec(
        name="baseline_kernel_update",
        key=("baseline_kernel_update", float(lr), float(lengthscale)),
        make=make, in_kinds=("state", "state"), out_kinds=("in:0",))


_COLLECT = ProgramSpec(
    name="baseline_swag_collect", key=("baseline_swag_collect",),
    make=lambda ctx: lambda state, params: (swag_collect(state, params),),
    in_kinds=("state", "state"), out_kinds=("in:0",))


def _train_steps(progs, spec, rows, opt_rows, batch):
    """One step of every NN in turn, each through its own program (looked
    up on its first step, with the very batch it is then called with).
    Yields each NN's loss tensor."""
    for i, (p, s) in enumerate(zip(rows, opt_rows)):
        if progs[i] is None:
            progs[i] = _program(spec, p, s, batch)
        yield progs[i](p, s, batch)[2]


def ensemble_baseline(module, optimizer, n: int, dataloader, epochs: int,
                      seed: int = 0, *, device=None):
    """Sequential deep ensemble: train each NN one after another, reading
    each loss on the host after its step. Returns (the n trained param
    trees, the last loss of each)."""
    device = _device(device)
    all_params = _inits(module, n, seed, device)
    rows = [_row(p) for p in all_params]
    opt_rows = [_row(optimizer.init(p)) for p in all_params]
    spec = _sgd_step_spec(module, optimizer)
    progs, losses = [None] * n, [0.0] * n
    for _ in range(epochs):
        for batch in dataloader:
            batch = to_device(batch, device)
            for i, loss in enumerate(_train_steps(progs, spec, rows,
                                                  opt_rows, batch)):
                losses[i] = float(loss[0])
    return all_params, losses


def multiswag_baseline(module, optimizer, n: int, dataloader, epochs: int,
                       pretrain_epochs: int = 0, max_rank: int = 20,
                       seed: int = 0, *, device=None):
    """Sequential multi-SWAG: ensemble training, then after each epoch
    past ``pretrain_epochs`` one moment collection per NN (``swag_collect``
    on its one-row view: one moments launch a NN). Returns (the n
    trained param trees, their SWAG states)."""
    device = _device(device)
    all_params = _inits(module, n, seed, device)
    rows = [_row(p) for p in all_params]
    opt_rows = [_row(optimizer.init(p)) for p in all_params]
    swag_states = [swag_state_init(p, max_rank) for p in all_params]
    swag_rows = [_row(s) for s in swag_states]
    spec = _sgd_step_spec(module, optimizer)
    progs, collects = [None] * n, [None] * n
    for e in range(epochs):
        for batch in dataloader:
            batch = to_device(batch, device)
            for _ in _train_steps(progs, spec, rows, opt_rows, batch):
                pass
        if e >= pretrain_epochs:
            for i, (s, p) in enumerate(zip(swag_rows, rows)):
                if collects[i] is None:
                    collects[i] = _program(_COLLECT, s, p)
                collects[i](s, p)
    return all_params, swag_states


def _ravel_into(row, tree):
    """``tree`` raveled in ``ravel_pytree``'s column order into ``row``."""
    torch.cat([x.reshape(-1) for x in tree_flatten(tree, sort_keys=True)[0]],
              out=row)


def svgd_baseline(module, n: int, dataloader, epochs: int, *, lr: float,
                  lengthscale: float = 1.0, seed: int = 0, device=None):
    """Monolithic SVGD: each NN's grad in turn, then the full kernel
    matrix over the stacked ``(n, D)`` params and grads and one update of
    all params, unraveled back into each NN (one copy of each NN, no
    concurrency: paper §5.1's baseline). ``lengthscale <= 0`` takes the
    median heuristic. Returns the n param trees."""
    device = _device(device)
    all_params = _inits(module, n, seed, device)
    rows = [_row(p) for p in all_params]
    theta, unravel = functional.flatten_rows(all_params)
    g = torch.empty_like(theta)
    grad_spec = _grad_spec(module)
    upd_spec = _kernel_update_spec(lr, lengthscale)
    grad_progs, upd = [None] * n, None
    for _ in range(epochs):
        for batch in dataloader:
            batch = to_device(batch, device)
            for i, p in enumerate(rows):                    # sequential
                if grad_progs[i] is None:
                    grad_progs[i] = _program(grad_spec, p, batch)
                grads, = grad_progs[i](p, batch)
                _ravel_into(g[i], grads)
                del grads
            for i, p in enumerate(all_params):
                _ravel_into(theta[i], p)
            if upd is None:
                upd = _program(upd_spec, theta, g)
            upd(theta, g)
            for i, p in enumerate(all_params):
                tree_map(torch.Tensor.copy_, p, unravel(theta[i]))
    return all_params
