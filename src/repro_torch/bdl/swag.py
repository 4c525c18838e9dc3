"""SWAG / MultiSWAG (Maddox et al., 2019; Wilson & Izmailov, 2020)
(counterpart of ``repro.bdl.swag``: the NEL and the compiled stacked-axis
paths).

SWAG assumes the posterior is Normal with moments taken from the SGD
trajectory:

    mean     <- running average of theta
    sq_mean  <- running average of theta^2
    dev      <- ring buffer of the last K deviations (low-rank covariance)

sample:  theta = mean + sigma_diag^(1/2) z1 / sqrt(2)
                      + D z2 / sqrt(2 (K - 1))

MultiSWAG = an ensemble of SWAG particles, each with its own moments in
the store's ``"swag"`` key. Stacked, ``n`` and ``rank`` are ``(P,)``: one
count per row, so the ring slot ``rank % max_rank`` is per row. The
moment collection and the serve-time diagonal scale run through the
hand-written kernels (``kernels.ops``: CUDA on the card, the plain
versions on the CPU): the collection is one launch over every parameter
leaf (one per ``kernels.swag_moments.MAX_LEAVES`` leaves; under bf16
masters too, on fp32 copies of the params), and so is the diagonal scale,
computed once per particle whatever the number of draws (once per
stacked state in ``_sample``, once per live particle in
``sample_predict``). The collection writes the deviation ring in place:
it is ``max_rank`` times the parameters, too large to copy per
collection.

Under ``backend="nel"`` every particle steps on its own timeline and,
once per epoch after the pretraining, handles ``SWAG_COLLECT``: the same
collection over one-row views of its own state (P = 1: one moments
launch per particle), written back through ``particle.state``
so that the store's version and dirty tracking see it.

Sampling takes its Gaussian noise as an input (``z1`` per leaf, ``z2``
per rank slot): ``jax.random`` and torch give different numbers, so
parity checks hand the reference's own noise across; the serving path
draws it from a ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

from ..core.store import Sharded
from ..core.tree import Group, to_device, tree_flatten, tree_leaves, tree_map
from ..sharding.rules import named_leaves, split_leaf
from ..kernels import ops as _kops
from ..runtime import specs
from .infer import Infer, traced_epochs


def _moment_zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


def swag_state_init(params, max_rank: int = 20):
    """One particle's SWAG state (zero moments, an empty ring). The moments
    are fp32 whatever the params' dtype, the ring follows the params: the
    reference's state takes the same dtypes at its first collection (its
    bf16 params times its fp32 count give fp32 moments), and the port's
    in-place collection cannot change a dtype."""
    dev = tree_leaves(params)[0].device
    return {
        "n": torch.zeros((), dtype=torch.float32, device=dev),
        "mean": tree_map(_moment_zeros, params),
        "sq_mean": tree_map(_moment_zeros, params),
        "dev": tree_map(lambda p: p.new_zeros((max_rank,) + tuple(p.shape)),
                        params),
        "rank": torch.zeros((), dtype=torch.int32, device=dev),
    }


def swag_collect(state, params, mask=None):
    """One moment collection over the stacked state (after an epoch, in
    the paper's setup), in place: live rows (``mask`` None: all) take the
    new moments, count and rank, and write their deviation into ring slot
    ``rank % max_rank``; dead rows keep everything bit for bit. Returns
    ``state`` itself, every leaf at its address (a captured collection
    replays on the store's tensors)."""
    means = tree_flatten(state["mean"], sort_keys=True)[0]
    sqs, devs, thetas = (tree_flatten(t, sort_keys=True)[0] for t in
                         (state["sq_mean"], state["dev"], params))
    max_rank = devs[0].shape[1]
    n, rank = state["n"], state["rank"]
    slot = (rank % max_rank).to(torch.int32)
    _kops.swag_moments_leaves(means, sqs, [t.contiguous() for t in thetas],
                              n, mask, devs, slot)
    live = torch.ones_like(n, dtype=torch.bool) if mask is None else mask > 0
    torch.where(live, n + 1, n, out=n)
    torch.where(live, rank + 1, rank, out=rank)
    return state


def diag_scales(stacked_state, diag_std_leaves=_kops.diag_std_leaves):
    """The diagonal scale ``sqrt(max(sq_mean - mean^2, 1e-30))`` of every
    leaf of a stacked SWAG state, in sorted key-path order: one
    ``diag_std_leaves`` call (the kernel's dispatch; parity checks pass
    its plain version)."""
    means = tree_flatten(stacked_state["mean"], sort_keys=True)[0]
    sqs = tree_flatten(stacked_state["sq_mean"], sort_keys=True)[0]
    return diag_std_leaves([m.contiguous() for m in means],
                           [s.contiguous() for s in sqs])


def _sample(stacked_state, z1, z2, scale: float, stds=None):
    """S draws from each of P particles' Gaussians. z1: tree like the mean
    with leaves (P, S, ...); z2: (P, S, max_rank). Returns stacked params
    with leading P*S (sample j of particle i at row i*S + j). Each
    particle's state is read once, never repeated per sample; the
    diagonal scale of every leaf is computed once, in one
    ``diag_scales`` call, or given as ``stds`` (``diag_scales`` of this
    state; parity checks pass its plain version's)."""
    # leaves matched by key path (sorted keys), whatever the dict order
    means, unflatten = tree_flatten(stacked_state["mean"], sort_keys=True)
    devs, zs = (tree_flatten(t, sort_keys=True)[0] for t in
                (stacked_state["dev"], z1))
    if stds is None:
        stds = diag_scales(stacked_state)
    P, S, max_rank = z2.shape
    rank = stacked_state["rank"]
    k_eff = torch.clamp(torch.minimum(rank, torch.full_like(rank, max_rank))
                        .float(), min=2.0)                          # (P,)
    slots = torch.arange(max_rank, device=rank.device)
    zw = z2 * (slots[None, :] < rank[:, None]).float()[:, None, :]  # (P,S,R)
    lr_scale = torch.sqrt(2.0 * (k_eff - 1.0))                      # (P,)
    out = []
    for m, std, d, z in zip(means, stds, devs, zs):
        lead = (P,) + (1,) * (z.dim() - 1)
        diag = std[:, None] * z / math.sqrt(2.0)
        lowrank = torch.bmm(zw.to(d.dtype), d.reshape(P, max_rank, -1)
                            ).reshape(z.shape) / lr_scale.reshape(lead)
        sample = m[:, None] + scale * (diag + lowrank).to(m.dtype)
        out.append(sample.reshape((P * S,) + tuple(m.shape[1:])))
    return unflatten(out)


def swag_sample(state, z1, z2, scale: float = 1.0, stds=None):
    """One parameter sample from one particle's SWAG Gaussian with the
    given noise: ``z1`` a tree like the mean, ``z2`` (max_rank,).
    ``stds``, when given, is ``diag_scales`` of the state with a leading
    axis of one (``state`` as a one-row stack): reused over a particle's
    draws, it spares each draw the scale's launch."""
    one = tree_map(lambda x: x[None], state)
    sample = _sample(one, tree_map(lambda z: z[None, None], z1),
                     z2[None, None], scale, stds=stds)
    return tree_map(lambda x: x[0], sample)


def swag_sample_stacked(stacked_state, samples_per_particle: int,
                        scale: float = 1.0, *, generator=None, noise=None):
    """Serve-time sampling over the store's stacked SWAG moments: S draws
    from every particle's Gaussian, stacked params with leading n*S
    (sample j of particle i at row i*S + j), the shape a PredictiveEngine
    serves. ``noise=(z1, z2)`` gives the noise (z1 leaves (n, S, ...), z2
    (n, S, max_rank)); otherwise it is drawn from ``generator`` (one
    seeded 0 on the state's device when None, as the reference defaults
    to ``PRNGKey(0)``)."""
    if noise is None:
        noise = swag_noise(stacked_state, tree_leaves(
            stacked_state["mean"])[0].shape[0], samples_per_particle,
            generator)
    return _sample(stacked_state, *noise, scale)


def swag_noise(stacked_state, n: int, samples_per_particle: int,
               generator=None):
    """The noise ``swag_sample_stacked`` draws for ``n`` particles shaped
    like ``stacked_state``'s rows: (z1 leaves (n, S, ...), z2 (n, S,
    max_rank)), from ``generator`` (one seeded 0 on the state's device
    when None) in that order."""
    S = samples_per_particle
    mean = stacked_state["mean"]
    max_rank = tree_leaves(stacked_state["dev"])[0].shape[1]
    dev = tree_leaves(mean)[0].device if generator is None \
        else generator.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shape):
        return torch.randn(shape, generator=generator, device=dev)

    return (tree_map(lambda m: draw((n, S) + tuple(m.shape[1:])), mean),
            draw((n, S, max_rank)))


def _sample_on_positions(store, samples_per_particle, scale, generator,
                         noise):
    """Serve-time sampling on a store split over a mesh: each position
    samples its own live particles' Gaussians (the diagonal scale runs
    there, one launch a position or model shard), from the noise drawn
    for every live particle at once as ``swag_sample_stacked`` draws it,
    so the members equal the one-device sampling's, in the same order. A
    ``Sharded`` tree of the draws, position by position. Under a model
    axis each model position samples its shard of every leaf, from its
    part of the same noise (a replicated leaf from the whole of it), and
    the draws of a data position are a ``Group``."""
    sw = store.stacked("swag")
    live = [store.slot_of(p) for p in store.pids]
    if noise is None:
        template = sw.shards[0]
        if isinstance(template, Group):
            if generator is None:
                generator = torch.Generator(
                    device=sw.devices[0]).manual_seed(0)
            template = {"mean": _whole_shapes(template, "mean/"),
                        "dev": template[0]["dev"]}
        noise = swag_noise(template, len(live), samples_per_particle,
                           generator)
    z1, z2 = noise
    parts, devices, at = [], [], 0
    for dev, shard, lo, hi in zip(sw.devices, sw.shards, sw.bounds[:-1],
                                  sw.bounds[1:]):
        rows = [s - lo for s in live if lo <= s < hi]
        if not rows:
            continue
        idx = torch.tensor(rows, device=dev)
        state = tree_map(lambda x: x.index_select(0, idx), shard)
        take = slice(at, at + len(rows))
        at += len(rows)
        if isinstance(state, Group):
            parts.append(_sample_group(state, tree_map(lambda z: z[take], z1),
                                       z2[take], scale))
        else:
            parts.append(_sample(state, tree_map(lambda z: z[take].to(dev),
                                                 z1), z2[take].to(dev),
                                 scale))
        devices.append(dev)
    return Sharded(parts, devices, sw.plan)


def _whole_shapes(group: Group, prefix: str):
    """The ``prefix`` subtree of a Group's first shard with each leaf's
    whole (joined) shape, on the meta device."""
    m = len(group)

    def full(path, x):
        shape = list(x.shape)
        dim = group.dims[prefix + path]
        if dim is not None:
            shape[dim] *= m
        return torch.empty(shape, dtype=x.dtype, device="meta")

    sub = group[0][prefix.rstrip("/")]
    leaves, unflatten = tree_flatten(sub)
    return unflatten([full(p, x) for (p, _), x in
                      zip(named_leaves(sub), leaves)])


def _sample_group(state: Group, z1, z2, scale: float) -> Group:
    """``_sample`` on each model position of a group's SWAG state, with
    its part of the noise ``z1`` (split like the means) and all of
    ``z2``: a Group of the draws, with the params' dims."""
    m = len(state)
    dims = {p[len("mean/"):]: d for p, d in state.dims.items()
            if p.startswith("mean/")}
    leaves, unflatten = tree_flatten(z1)
    paths = [p for p, _ in named_leaves(z1)]
    shards = []
    for j, (shard, d) in enumerate(zip(state, state.devices)):
        zj = unflatten([split_leaf(z, dims[p], m, j).to(d)
                        for p, z in zip(paths, leaves)])
        shards.append(_sample(shard, zj, z2.to(d), scale))
    return Group(shards, dims, state.devices)


def _swag_collect_msg(particle):
    """SWAG_COLLECT handler: one collection of this particle's moments,
    in place on one-row views of its state, then written back."""
    swag = particle.state["swag"]
    swag_collect(tree_map(lambda x: x[None], swag),
                 tree_map(lambda x: x[None], particle.state["params"]))
    particle.state["swag"] = swag


class MultiSWAG(Infer):
    def _create(self, optimizer, num_particles, max_rank):
        pids = []
        for _ in range(num_particles):
            pid = self.push_dist.p_create(
                optimizer, receive={"SWAG_COLLECT": _swag_collect_msg})
            p = self.push_dist.particles[pid]
            p.state["swag"] = swag_state_init(p.state["params"], max_rank)
            pids.append(pid)
        return pids

    def _nel_infer(self, dataloader, epochs: int, *, optimizer,
                   num_particles: int = 4, pretrain_epochs: int = 0,
                   max_rank: int = 20):
        pd = self.push_dist
        pids = self._create(optimizer, num_particles, max_rank)
        losses = []
        for e in traced_epochs(epochs, "swag"):
            for batch in dataloader:
                batch = self._batch(batch)
                futs = [pd.particles[pid].step(batch) for pid in pids]
                losses = [float(f.wait()) for f in futs]
            if e >= pretrain_epochs:    # collect moments once per epoch
                pd.p_wait([pd.p_launch(pid, "SWAG_COLLECT") for pid in pids])
        return pids, losses

    def _fused_infer(self, dataloader, epochs: int, *, optimizer,
                     num_particles: int = 4, pretrain_epochs: int = 0,
                     max_rank: int = 20):
        pids = self._create(optimizer, num_particles, max_rank)
        losses = self._fused_epochs(pids, dataloader, epochs,
                                    optimizer=optimizer,
                                    pretrain_epochs=pretrain_epochs)
        return pids, losses

    def _fused_epochs(self, pids, dataloader, epochs: int, *, optimizer,
                      pretrain_epochs: int = 0):
        """Stacked-axis MultiSWAG on existing particles: the ensemble
        train step every batch and, after ``pretrain_epochs``, one moment
        collection per epoch, two programs fetched once each per fused
        run; params, optimizer state and SWAG state are checked out once,
        updated in place and committed back once."""
        rt = self._compiled_runtime()
        step_spec = specs.ensemble_step(self.module.loss, optimizer,
                                        precision=self.precision)
        collect_spec = specs.map_step(swag_collect, key=("swag_collect",),
                                      n_state=2, masked=True)
        co_pids, mask, slots = self._fused_plan(pids)
        step, collect, ls = None, None, None
        with self._checked_out(co_pids,
                               ("params", "opt_state", "swag")) as co:
            for e in traced_epochs(epochs, "swag"):
                for batch in dataloader:
                    batch = self._batch(batch)
                    if step is None:    # one cache lookup per fused run
                        step = rt.program(step_spec, co["params"],
                                          co["opt_state"], batch, mask)
                    co["params"], co["opt_state"], ls = step(
                        co["params"], co["opt_state"], batch, mask)
                if e >= pretrain_epochs:
                    if collect is None:
                        collect = rt.program(collect_spec, co["swag"],
                                             co["params"], mask)
                    co["swag"], = collect(co["swag"], co["params"], mask)
        return self._losses(ls, slots)

    def posterior_predictive(self, *, samples_per_particle: int = 0,
                             scale: float = 1.0, generator=None, noise=None,
                             **kw):
        """Serve-time handoff: with ``samples_per_particle=S > 0`` the
        service does BMA over n*S draws from each particle's SWAG Gaussian
        (sampled once, up front, into a static stacked tree — the
        MultiSWAG predictive of Wilson & Izmailov 2020) instead of the
        particle params. S=0 serves the live particle params like any
        other Infer. The diagonal scale of every leaf is one
        ``diag_std_leaves`` launch (one per position or model shard on a
        mesh).
        On a store split over a mesh (served on its own placement) each
        position samples its own particles and keeps their draws, one
        shard a position (``_sample_on_positions``).
        The noise comes from ``generator`` (a
        ``torch.Generator`` on the store's device; one seeded 0 when None)
        or is given as ``noise=(z1, z2)``. Every other keyword goes on to
        ``serve``. A live particle with no SWAG state (a fresh particle in
        a killed one's slot) raises KeyError (``store.dense``)."""
        if samples_per_particle <= 0:
            return super().posterior_predictive(**kw)
        store = self.store
        if (isinstance(store.stacked("swag"), Sharded)
                and kw.get("placement") in (None, store.placement)):
            with torch.no_grad():
                sampled = _sample_on_positions(
                    store, samples_per_particle, scale, generator, noise)
            return self.push_dist.serve(params=sampled, **kw)
        # dense live rows (not the capacity-padded canonical form): a
        # padding slot's zero moments must never be sampled as a member
        stacked_swag = store.dense("swag")
        with torch.no_grad():
            sampled = swag_sample_stacked(stacked_swag, samples_per_particle,
                                          scale, generator=generator,
                                          noise=noise)
        return self.push_dist.serve(params=sampled, **kw)

    def sample_predict(self, batch, *, samples_per_particle: int = 5,
                       scale: float = 1.0, generator=None, noise=None):
        """MultiSWAG prediction: the mean over S draws from every live
        particle's SWAG Gaussian of the raw forward outputs (the logits,
        not their probabilities), as the reference's. Each draw is one
        ``swag_sample`` of that particle's ``state["swag"]`` and one
        ``module._forward``. ``noise`` is the list of per-draw ``(z1,
        z2)`` in draw order (particle by particle, S draws each);
        otherwise each draw's noise comes from ``generator`` (one seeded
        0 on the store's device when None). Each particle's diagonal
        scale is computed once (one ``diag_scales`` call) and reused over
        its S draws."""
        pd = self.push_dist
        draws = iter(noise) if noise is not None else None
        dev = torch.device(self.store.device)
        if draws is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        batch = to_device(batch, dev)
        total, count = None, 0
        for pid in pd.particle_ids():
            swag = pd.particles[pid].state["swag"]
            with torch.no_grad():
                stds = diag_scales(tree_map(lambda x: x[None], swag))
            for _ in range(samples_per_particle):
                if draws is not None:
                    z1, z2 = next(draws)
                else:
                    z1 = tree_map(lambda m: torch.randn(
                        m.shape, generator=generator, device=dev),
                        swag["mean"])
                    z2 = torch.randn(tree_leaves(swag["dev"])[0].shape[0],
                                     generator=generator, device=dev)
                with torch.no_grad():
                    out = self.module._forward(
                        swag_sample(swag, z1, z2, scale, stds), batch)
                total = out if total is None else tree_map(
                    torch.add, total, out)
                count += 1
        return tree_map(lambda t: t / count, total)
