"""Stein Variational Gradient Descent (Liu & Wang, 2016) on particles
(counterpart of ``repro.bdl.svgd``: the paper's leader protocol on the
NEL, and the compiled stacked-axis path).

Update rule (standard SVGD, descent form):

    theta_i <- theta_i - (lr / n) * sum_j [ k(theta_j, theta_i) * g_j
                                            - (theta_i - theta_j)/ell^2 * k_ji ]

with g_j = grad of the loss (= -grad log posterior), k = RBF with
bandwidth ell (fixed, or the median heuristic when lengthscale <= 0).

The all-to-all the paper names as SVGD's bottleneck (§5.1) runs through
the hand-written kernels (``kernels.ops``: CUDA on the card, the plain
versions on the CPU): ``pairwise_sqdist`` over the stacked (n, D) matrix,
then the (n, n) glue in plain torch (diagonal zeroing, exp, the mask's
outer product, ksum, n_eff, ell — plain jnp in the reference), then the
force kernel streaming D against K^T / n_eff. Both kernels take the
store's row mask, so they sit on the fused path; the reference's Pallas
kernels are dense-only, and its fused step runs the jnp form instead.
With ``lengthscale <= 0`` the port follows the jnp semantics (the median
heuristic, over live pairs when masked), not the Pallas path's raw ell.

On a store split over a mesh the fused step is three programs with the
gather between them (``_MeshStep``); with one position it is the step
above. The gather runs over ``data`` only, per model shard (a
particle-only mesh has one): each shard's columns of the (n, D)
matrix stay at its model position, #1 gives a partial (n, n) per shard,
the partials are summed in position order and the kernel matrix is
built from that sum, and #2 runs on each shard's columns with the
shared K. A replicated leaf's columns belong to the first model shard
alone (counted once in the distances), and its update is copied from
there to every copy.

Under ``backend="nel"`` (paper Fig. 6) the leader particle steps every
particle (``SVGD_STEP``: a backward pass, grads stashed in the store),
gathers read-only clones of their params and grads (``get``), stacks
them into (n, D) fp32 ``theta`` and ``g`` and calls ``svgd_force`` with
no mask: on the card one launch of each kernel per step. It then sends
each particle its row of phi (``SVGD_FOLLOW``).
"""
from __future__ import annotations

import math

import torch

from ..core import functional
from ..core import precision as precision_mod
from ..core.store import Sharded
from ..core.tree import Group, tree_map
from ..obs import device as _obs
from ..runtime.program import device_guard
from ..sharding.rules import named_leaves
from ..kernels import ops as _kops
from ..runtime.program import ProgramSpec, ident
from .infer import Infer, traced_epochs


def _median(x):
    """``jnp.median``: the mean of the two middle values for an even
    count (``torch.median`` returns the lower one)."""
    return torch.quantile(x.flatten(), 0.5)


def rbf_lengthscale(sq, lengthscale: float, mask=None):
    """ell from the (n, n) squared distances: ``lengthscale`` when > 0,
    else the median heuristic (Liu & Wang §5), over live pairs only when
    a mask is given."""
    if lengthscale > 0:
        # a fill on the device: no host-to-device copy, which a stream
        # being captured refuses
        return torch.full((), lengthscale, dtype=sq.dtype, device=sq.device)
    n = sq.shape[0]
    if mask is None:
        return torch.sqrt(0.5 * _median(sq) / math.log(n + 1.0) + 1e-12)
    mb = mask > 0
    pair = mb[:, None] & mb[None, :]
    med = torch.nanquantile(torch.where(pair, sq, math.nan).flatten(),
                            0.5).nan_to_num()
    n_eff = mask.to(sq.dtype).sum().clamp(min=1.0)
    return torch.sqrt(0.5 * med / torch.log(n_eff + 1.0) + 1e-12)


def svgd_force(theta, grads, lengthscale: float, mask=None):
    """theta, grads: (n, D) fp32 -> phi: (n, D) descent direction.

    phi_i = (1/n) sum_j [ k_ji g_j - k_ji (theta_i - theta_j) / ell^2 ]

    With an (n,) active ``mask`` the sum runs over live rows only: dead
    rows are read as zeros (NaN there cannot leak), fall out of the
    kernel matrix through the mask's outer product, and get phi = 0; the
    live rows equal the dense force over just those rows."""
    sq = _kops.pairwise_sqdist(theta, mask)
    return _kops.svgd_force(theta, grads, *rbf_glue(sq, lengthscale, mask),
                            mask)


def rbf_glue(sq, lengthscale: float, mask=None):
    """The (n, n) glue between the two kernels, plain torch as it is plain
    jnp in the reference: from the squared distances, ``(ktn, ksum,
    inv_ell2)`` = (K^T / n_eff, K.sum(0) / n_eff, 1 / ell^2) with
    K = exp(-d2 / (2 ell^2)), a zero diagonal and, with a mask, dead pairs
    out and n_eff the live count."""
    n = sq.shape[0]
    ell = rbf_lengthscale(sq, lengthscale, mask)
    d2 = sq * (1.0 - torch.eye(n, dtype=sq.dtype, device=sq.device))
    K = torch.exp(-0.5 * d2 / (ell * ell))                   # (n, n), k_ji
    if mask is None:
        n_eff = float(n)
    else:
        m = mask.to(sq.dtype)
        K = K * (m[:, None] * m[None, :])   # dead pairs fall out of the kernel
        n_eff = m.sum().clamp(min=1.0)
    return ((K.T / n_eff).contiguous(), K.sum(0) / n_eff,
            (1.0 / (ell * ell)).reshape(1))


def fused_svgd_step(loss_fn, *, lr: float, lengthscale: float = 1.0,
                    compute_dtype=None):
    """One SVGD step over stacked particles: ``step(stacked_params, batch,
    mask=None) -> (stacked_params, losses)``. The params flatten to the
    (n, D) matrix in ``ravel_pytree``'s column order; each leaf takes its
    columns of the update in place, so the caller's own tree comes back.
    Dead slots stay bit-for-bit frozen and report loss 0.0.
    ``compute_dtype``: the backward pass runs on a cast of the params and
    the batch (``functional.ensemble_value_and_grad``); the kernel force
    is fp32 either way, and the update lands in the masters' dtype."""
    vag = functional.ensemble_value_and_grad(loss_fn, compute_dtype)

    def step(stacked_params, batch, mask=None):
        losses, grads = vag(stacked_params, batch)
        theta, unravel = functional.flatten_stacked(stacked_params)
        g, _ = functional.flatten_stacked(grads)
        del grads
        phi = svgd_force(theta.float(), g.float(), lengthscale, mask=mask)
        del g, theta
        # theta - lr * phi into each leaf, a leaf at a time over its own
        # columns of phi (the matrix's elementwise arithmetic)
        tree_map(lambda p, f: functional.masked_assign(
            mask, p - lr * f.to(p.dtype), p), stacked_params, unravel(phi))
        if mask is not None:
            losses = torch.where(mask > 0, losses, 0.0)
        return stacked_params, losses

    return step


def svgd_step_spec(loss_fn, *, lr: float, lengthscale: float = 1.0,
                   precision=None) -> ProgramSpec:
    """The fused SVGD step as a ``ProgramSpec``: ``fused(stacked_params,
    batch, mask) -> (stacked_params, losses)``, the params updated in
    place (the reference donates them). ``precision`` selects the compute
    dtype of the backward pass (``fused_svgd_step``); a spec that casts
    carries ``Precision.key()``, the fp32 spec None."""
    prec = precision_mod.get(precision)
    cd = prec.compute if prec.casts_compute else None
    return ProgramSpec(
        name="svgd_step",
        key=("svgd_step", ident(loss_fn), float(lr), float(lengthscale)),
        make=lambda ctx: fused_svgd_step(loss_fn, lr=lr,
                                         lengthscale=lengthscale,
                                         compute_dtype=cd),
        in_kinds=("state", "replicated", "vector"),
        out_kinds=("in:0", "vector"),
        precision=prec.key() if prec.casts_compute else None)


# ---------------------------------------------------------------------------
# the step over a mesh: three programs with the gather between them
# ---------------------------------------------------------------------------

def _owned(shard, dims, j: int):
    """The leaves whose columns model position j's block of the flattened
    matrix holds, in ``ravel_pytree``'s order: its split leaves, and the
    replicated ones at the first position only."""
    return [x for p, x in named_leaves(shard, sort_keys=True)
            if dims[p] is not None or j == 0]


def _flatten_leaves_into(leaves, out):
    n = out.shape[0]
    parts = [x.reshape(n, -1) for x in leaves]
    if all(x.dtype == out.dtype for x in parts):
        torch.cat(parts, dim=1, out=out)
    else:
        out.copy_(torch.cat(parts, dim=1))


def svgd_grads_spec(loss_fn, *, precision=None) -> ProgramSpec:
    """A data position's first stage of the SVGD step on a mesh, over its
    model group: ``fused(params, batch, mask, theta, g) -> (losses,
    theta, g)``, its rows' losses (0.0 at dead slots) and grads, the
    params and grads flattened in ``ravel_pytree``'s column order into
    ``theta`` / ``g``, Groups of each model position's fp32 (rows, D_j)
    block, in place."""
    prec = precision_mod.get(precision)
    cd = prec.compute if prec.casts_compute else None

    def make(ctx):
        vag = functional.ensemble_value_and_grad(loss_fn, cd)

        def fused(params, batch, mask, theta, g):
            losses, grads = vag(params, batch)
            for j in range(len(params)):
                _flatten_leaves_into(_owned(params[j], params.dims, j),
                                     theta[j])
                _flatten_leaves_into(_owned(grads[j], params.dims, j), g[j])
            return torch.where(mask > 0, losses, 0.0), theta, g

        return fused

    return ProgramSpec(
        name="svgd_grads", key=("svgd_grads", ident(loss_fn)),
        make=make, in_kinds=("state", "replicated", "vector", "rows", "rows"),
        out_kinds=("vector", "in:3", "in:4"),
        precision=prec.key() if prec.casts_compute else None)


def svgd_phi_spec(lengthscale: float) -> ProgramSpec:
    """The middle stage, once, on the first data position's model group:
    ``fused(theta, g, mask, phi) -> (phi,)`` over Groups of the gathered
    (n, D_j) blocks: #1 per block, the partial distances summed in
    position order on the first position, the glue once on that sum, and
    #2 per block with the shared K, written into ``phi`` in place."""
    def make(ctx):
        def fused(theta, g, mask, phi):
            sq = None
            for t in theta:
                part = _kops.pairwise_sqdist(t, mask.to(t.device))
                sq = part if sq is None else sq + part.to(sq.device)
            glue = rbf_glue(sq, lengthscale, mask)
            for t, gj, f in zip(theta, g, phi):
                d = t.device
                _kops.svgd_force(t, gj, *(x.to(d) for x in glue),
                                 mask.to(d), out=f)
            return (phi,)

        return fused

    return ProgramSpec(
        name="svgd_phi", key=("svgd_phi", float(lengthscale)),
        make=make, in_kinds=("rows", "rows", "vector", "rows"),
        out_kinds=("in:3",))


def svgd_apply_spec(lr: float) -> ProgramSpec:
    """A data position's last stage over its model group: ``fused(params,
    phi, mask) -> (params,)``, theta - lr * phi into each owned leaf's
    live rows in place, then every replicated leaf copied from the first
    position to the others (bit-equal copies)."""
    def make(ctx):
        def fused(params, phi, mask):
            dims = params.dims
            for j, (shard, f) in enumerate(zip(params, phi)):
                leaves = _owned(shard, dims, j)
                mk = mask.to(f.device)
                cols = f.split([x[0].numel() for x in leaves], dim=1)
                for x, c in zip(leaves, cols):
                    functional.masked_assign(
                        mk, x - lr * c.reshape(x.shape).to(x.dtype), x)
            first = named_leaves(params[0])
            for j in range(1, len(params)):
                for (p, x0), (_, x) in zip(first, named_leaves(params[j])):
                    if dims[p] is None:
                        x.copy_(x0)
            return (params,)

        return fused

    return ProgramSpec(
        name="svgd_apply", key=("svgd_apply", float(lr)), make=make,
        in_kinds=("state", "rows", "vector"), out_kinds=("in:0",))


class _MeshStep:
    """The SVGD step over params split on a mesh (``core.store.Sharded``)
    as model groups: a particle-only mesh's shard is a group of one
    (``_grouped``). Per data position the grads stage over its group
    (``svgd_grads_spec``); per model position j the (rows, D_j) blocks
    gathered over ``data`` in slot order into (n, D_j) on position
    (0, j), where #1 and #2 run (``svgd_phi_spec``); each data position
    takes its rows of phi back (``svgd_apply_spec``). A block on its
    gathered block's device is a view of it, so the gather and the
    scatter copy only what lives elsewhere. Three programs per step,
    each captured once per data position it runs at; no collective over
    the particle axis in any."""

    def __init__(self, rt, module, params, batch, mask, *, lr, lengthscale,
                 precision):
        # the same wrapper every step for the same params: a captured
        # program's first call returns its warm-up's outputs only for the
        # very argument objects it was captured with
        self._wrapped = (params, _grouped(params))
        params = self._wrapped[1]
        g0 = params.shards[0]
        m = len(g0)
        widths = [sum(x[0].numel() for x in _owned(g0[j], g0.dims, j))
                  for j in range(m)]
        n = len(params)
        first = g0.devices

        def block(rows, j, dev):
            return torch.empty((rows, widths[j]), dtype=torch.float32,
                               device=dev)

        self.theta, self.g, self.phi = (
            Group([block(n, j, d) for j, d in enumerate(first)], None, first)
            for _ in range(3))
        self.copies = []                    # (i, j, here, lo, hi)
        for i, (lo, hi) in enumerate(zip(params.bounds[:-1],
                                         params.bounds[1:])):
            for j, d in enumerate(params.shards[i].devices):
                self.copies.append((i, j, d == first[j], lo, hi))

        def local(full):
            shards = []
            for i, grp in enumerate(params.shards):
                lo, hi = params.bounds[i], params.bounds[i + 1]
                shards.append(Group(
                    [full[j][lo:hi] if d == first[j] else block(hi - lo, j, d)
                     for j, d in enumerate(grp.devices)], None, grp.devices))
            return Sharded(shards, params.devices, params.plan)

        self.t_loc, self.g_loc, self.phi_loc = (
            local(self.theta), local(self.g), local(self.phi))
        self.grads = rt.program(svgd_grads_spec(module.loss,
                                                precision=precision),
                                params, batch, mask, self.t_loc, self.g_loc)
        self._first = (params, batch)
        self.losses, _, _ = self.grads(params, batch, mask, self.t_loc,
                                       self.g_loc)
        self._gather()
        mask0 = mask.to(first[0])
        with device_guard(first[0]):
            self.force = rt.program(svgd_phi_spec(lengthscale),
                                    self.theta, self.g, mask0, self.phi)
            self.force(self.theta, self.g, mask0, self.phi)
        self._scatter()
        self.apply = rt.program(svgd_apply_spec(lr), params, self.phi_loc,
                                mask)

    def _gather(self):
        for i, j, here, lo, hi in self.copies:
            if not here:
                self.theta[j][lo:hi].copy_(self.t_loc.shards[i][j])
                self.g[j][lo:hi].copy_(self.g_loc.shards[i][j])
                if _obs.counting_now():       # both blocks reach (0, j)
                    nbytes = 2 * 4 * (hi - lo) * self.theta[j].shape[1]
                    _obs.charge_collective("all-gather", nbytes,
                                           "svgd._MeshStep._gather",
                                           self.theta[j].device)

    def _scatter(self):
        for i, j, here, lo, hi in self.copies:
            if not here:
                self.phi_loc.shards[i][j].copy_(self.phi[j][lo:hi])

    def __call__(self, params, batch, mask):
        """One step: (params, losses)."""
        if params is not self._wrapped[0]:
            self._wrapped = (params, _grouped(params))
        grouped = self._wrapped[1]
        if self._first is not None:
            # the first step's grads and force ran at construction
            self._first = None
            self.apply(grouped, self.phi_loc, mask)
            return params, self.losses
        losses, _, _ = self.grads(grouped, batch, mask, self.t_loc,
                                  self.g_loc)
        self._gather()
        mask0 = mask.to(self.theta.devices[0])
        with device_guard(self.theta.devices[0]):
            self.force(self.theta, self.g, mask0, self.phi)
        self._scatter()
        self.apply(grouped, self.phi_loc, mask)
        return params, losses


def _grouped(params: Sharded) -> Sharded:
    """``params`` with each data position's shard a model group: a
    particle-only mesh's plain trees become groups of one, every leaf
    whole (the same tensors)."""
    if isinstance(params.shards[0], Group):
        return params
    dims = {p: None for p, _ in named_leaves(params.shards[0])}
    return Sharded([Group([s], dims, [d])
                    for s, d in zip(params.shards, params.devices)],
                   params.devices, params.plan)


# ---------------------------------------------------------------------------
# paper-faithful message-passing SVGD (Fig. 5 / Fig. 6)
# ---------------------------------------------------------------------------

def _svgd_step(particle, batch):
    """SVGD_STEP handler: local backward pass, stash grads."""
    return particle.grad(batch).wait()


def _svgd_follow(particle, lr, update):
    """SVGD_FOLLOW handler: apply the leader's kernel update."""
    return particle.apply_update(update, lr).wait()


def _svgd_leader(particle, lr, lengthscale, dataloader, epochs):
    """SVGD_LEADER handler (paper Fig. 6). Per batch: (1) step every
    particle (their backward passes queue on their devices), (2) gather
    every other particle's params and grads as read-only clones, (3) the
    kernel force over the (n, D) matrices, (4) SVGD_FOLLOW to every
    particle. ``dataloader`` yields batches already on the device."""
    others = [pid for pid in particle.particle_ids() if pid != particle.pid]
    losses = []
    for _ in traced_epochs(epochs, "svgd"):
        for batch in dataloader:
            # 1. step every particle
            fut = particle.grad(batch)
            futs = [particle.send(pid, "SVGD_STEP", batch) for pid in others]
            losses = [float(fut.wait())] + [float(f.wait()) for f in futs]

            # 2. gather every other particle's parameters + grads
            views = [particle.get(pid) for pid in others]
            views = [f.wait() for f in views]
            theta, unravel = functional.flatten_rows(
                [particle.state["params"]] + [v.parameters() for v in views])
            g, _ = functional.flatten_rows(
                [particle.state["grads"]] + [v.gradients() for v in views])
            del views

            # 3. kernel force (dense: every particle is live)
            phi = svgd_force(theta.float(), g.float(), lengthscale)
            del theta, g

            # 4. send updates (concurrent follow)
            futs = [particle.send(pid, "SVGD_FOLLOW", lr, unravel(phi[i + 1]))
                    for i, pid in enumerate(others)]
            _svgd_follow(particle, lr, unravel(phi[0]))
            for f in futs:
                f.wait()
    return losses


class SteinVGD(Infer):
    def _create(self, num_particles: int):
        """The leader on device 0, the others round-robin, each with the
        handlers of its role."""
        pd = self.push_dist
        pids = [pd.p_create(None, device=0,
                            receive={"SVGD_LEADER": _svgd_leader,
                                     "SVGD_STEP": _svgd_step,
                                     "SVGD_FOLLOW": _svgd_follow})]
        for p in range(num_particles - 1):
            pids.append(pd.p_create(
                None, device=(p + 1) % self.num_devices,
                receive={"SVGD_STEP": _svgd_step,
                         "SVGD_FOLLOW": _svgd_follow}))
        return pids

    def _nel_infer(self, dataloader, epochs: int, *, num_particles: int = 4,
                   lengthscale: float = 1.0, lr: float = 1e-3):
        pids = self._create(num_particles)
        losses = self.push_dist.p_wait([self.push_dist.p_launch(
            pids[0], "SVGD_LEADER", lr, lengthscale,
            self._on_device(dataloader), epochs)])[0]
        return pids, losses

    def _fused_infer(self, dataloader, epochs: int, *, num_particles: int = 4,
                     lengthscale: float = 1.0, lr: float = 1e-3):
        """Stacked-axis SVGD over fresh particles (same init stream as
        every other algorithm of this PD)."""
        pids = self._create(num_particles)
        losses = self._fused_epochs(pids, dataloader, epochs, lr=lr,
                                    lengthscale=lengthscale)
        return pids, losses

    def _fused_epochs(self, pids, dataloader, epochs: int, *,
                      lr: float = 1e-3, lengthscale: float = 1.0):
        """SVGD on existing particles through the step program, fetched
        once per fused run; the params are checked out once, updated in
        place every step and committed back once."""
        rt = self._compiled_runtime()
        spec = svgd_step_spec(self.module.loss, lr=lr,
                              lengthscale=lengthscale,
                              precision=self.precision)
        co_pids, mask, slots = self._fused_plan(pids)
        prog, ls = None, None
        with self._checked_out(co_pids, ("params",)) as co:
            for _ in traced_epochs(epochs, "svgd"):
                for batch in dataloader:
                    batch = self._batch(batch)
                    if prog is None:    # one cache lookup per fused run
                        prog = (_MeshStep(rt, self.module, co["params"],
                                          batch, mask, lr=lr,
                                          lengthscale=lengthscale,
                                          precision=self.precision)
                                if isinstance(co["params"], Sharded)
                                else rt.program(spec, co["params"], batch,
                                                mask))
                    co["params"], ls = prog(co["params"], batch, mask)
        return self._losses(ls, slots)
