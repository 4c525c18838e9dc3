"""The launch steps and abstract inputs for the dry run (counterpart of
``repro.launch.steps``).

The reference builds its steps on ``ShapeDtypeStruct``s and compiles them
for the production mesh. The port has no compiler to ask: it traces the
steps the card runs, eagerly, on fake tensors (``FakeTensorMode``:
shapes, dtypes and a device, no memory, no data), and counts what they do
(``launch.cost``). Every abstract input is one data position's: position
0's model group, since every data position runs the same shapes.

  train_step(params, opt, batch)            -> (params, opt, loss)
  svgd_step(params, batch, peers)           -> (params, losses)
  multiswag_step(params, opt, swag, batch)  -> (params, opt, swag, loss)
  prefill_step(params, batch)               -> (logits, caches)
  serve_step(params, token, caches, pos)    -> (logits, caches)

Placement. The particle axis rides ``data`` (P / data particles at each
data position) for training and a serve ensemble is replicated; under a
``model`` axis of m > 1 a data position's params are a ``core.tree.Group``
of m shards split by ``sharding.rules`` and run tensor-parallel
(``models.tp``). KV caches are placed by kv head, which is what
``models.tp`` runs (``"kv_layout": "heads"``); the reference shards the
cache's sequence over ``model`` instead (``cache_specs``), which the port
does not emulate (ROADMAP item 30). The specs the reference would give
(``batch_specs``, ``cache_specs``, ``residual_policy``) are kept as
tuples of axis names beside the placement.

Positions. The dry run's positions are fake devices (``trace_devices``):
``cuda:i`` where that many cards are visible, else ``meta:i``, since a
build without CUDA cannot run autograd on a fake CUDA tensor; a kernel
wrapper takes either as a card's tensor (``kernels.build.on_card``).
``build(..., init=gen)`` gives real inputs instead, drawn from ``gen`` on
the mesh's real devices, for a run on the card.

Refused, with the ROADMAP item: a plan in mode "fsdp_tp" (item 29) and a
multi-pod mesh (item 10c). On a model axis ``models.tp`` places every
family of the registry: a q-head count that the axis neither divides nor
is a multiple of still raises (item 31).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..bdl import svgd as svgd_mod
from ..bdl.swag import swag_collect
from ..core import functional
from ..core.tree import Group, tree_flatten, tree_leaves, tree_map
from ..models import api, tp
from ..obs import device as obs
from ..optim.optimizers import make as make_optimizer
from ..sharding import rules
from ..sharding.policy import activation_policy
from .plans import RunPlan

CACHE_DTYPE = torch.bfloat16
SWAG_RANK = 4                      # the reference's ring in the launch step


def trace_devices(n: int):
    """The dry run's ``n`` positions: ``cuda:0 .. n-1`` when that many
    cards are visible, else ``meta:0 .. n-1`` (fake tensors only; module
    docstring)."""
    kind = ("cuda" if torch.cuda.is_available()
            and n <= torch.cuda.device_count() else "meta")
    return [torch.device(kind, i) for i in range(n)]


def _group_devices(mesh):
    """Data position 0's model positions (its devices, in order)."""
    grid = mesh.devices
    while grid.ndim > 1:
        grid = grid[0]
    return list(grid.flat)


def local_sizes(plan: RunPlan, shape, mesh):
    """(particles, batch rows) at one data position: the particle axis
    split over ``data`` (training) or replicated (serving); a serving
    batch split over ``data`` where the axis divides it, else replicated,
    as the reference's specs place them."""
    data = mesh.shape.get("data", 1)
    P = plan.particles
    if plan.particle_axis == "data":
        if P % data:
            raise ValueError(f"{P} particles do not split over data {data}")
        P //= data
    B = shape.global_batch
    if plan.particle_axis is None and _div(B, mesh, "data"):
        B //= data
    return P, B


# --------------------------------------------------------------------------
# abstract (or real) state
# --------------------------------------------------------------------------

def _template(cfg):
    """One particle's param tree as fake CPU tensors: the init's shapes
    and dtypes (``api.param_footprint``'s trace)."""
    with FakeTensorMode():
        return api.init_params(torch.Generator(), cfg)


def _float_as(dtype):
    return lambda x: x.to(dtype) if x.is_floating_point() else x


def place(tree, mesh, lead: int = 1):
    """A stacked tree at data position 0: on its one device, or under a
    model axis of m > 1 a ``Group`` of m shards (``rules.model_dims``),
    shard j contiguous on model position j."""
    devices = _group_devices(mesh)
    m = mesh.shape.get("model", 1)
    if m == 1:
        return tree_map(lambda x: x.to(devices[0]), tree)
    dims = rules.model_dims(tree, m, lead=lead)
    paths = [p for p, _ in rules.named_leaves(tree)]
    leaves, unflatten = tree_flatten(tree)
    return Group([unflatten([rules.split_leaf(x, dims[p], m, j).contiguous()
                             .to(d) for p, x in zip(paths, leaves)])
                  for j, d in enumerate(devices)], dims, devices)


def abstract_params(cfg, plan: RunPlan, particles: int, mesh, init=None):
    """Data position 0's stacked params (``particles`` rows) cast to
    ``plan.param_dtype`` and placed (``place``): fake unless ``init``, a
    generator the rows are drawn from (``api.init_params``)."""
    dtype = getattr(torch, plan.param_dtype)
    if init is None:
        dev = _group_devices(mesh)[0]
        stacked = tree_map(lambda x: torch.empty(
            (particles,) + tuple(x.shape), device=dev,
            dtype=dtype if x.is_floating_point() else x.dtype),
            _template(cfg))
    else:
        rows = [api.init_params(init, cfg) for _ in range(particles)]
        stacked = tree_map(lambda *xs: _float_as(dtype)(torch.stack(xs)),
                           *rows)
    return place(stacked, mesh)


def _per_shard(fn, tree):
    if isinstance(tree, Group):
        return tree.like(fn(s) for s in tree.shards)
    return fn(tree)


def abstract_opt_state(cfg, plan: RunPlan, params):
    """The optimizer's state of ``params`` (per model shard): its step one
    int32 a particle, as the reference's vmapped init gives it."""
    opt = make_optimizer(cfg.optimizer, 1e-3)

    def init(shard):
        state = opt.init(shard)
        P = tree_leaves(shard)[0].shape[0]
        state["step"] = torch.zeros((P,), dtype=torch.int32,
                                    device=state["step"].device)
        return state

    return _per_shard(init, params)


def abstract_swag_state(params, max_rank: int = SWAG_RANK):
    """Zero SWAG moments of ``params`` (per model shard, fp32 moments, the
    ring in the params' dtype, ``n`` and ``rank`` one a particle):
    ``bdl.swag.swag_state_init`` stacked over the particles."""
    def init(shard):
        leaf = tree_leaves(shard)[0]
        P, dev = leaf.shape[0], leaf.device
        zeros = functools.partial(torch.zeros, device=dev)
        return {"n": zeros((P,), dtype=torch.float32),
                "mean": tree_map(lambda p: zeros(p.shape,
                                                 dtype=torch.float32), shard),
                "sq_mean": tree_map(lambda p: zeros(p.shape,
                                                    dtype=torch.float32),
                                    shard),
                "dev": tree_map(lambda p: zeros(
                    (P, max_rank) + tuple(p.shape[1:]), dtype=p.dtype),
                    shard),
                "rank": zeros((P,), dtype=torch.int32)}

    return _per_shard(init, params)


def abstract_cache(cfg, plan: RunPlan, params, batch: int, seq_len: int):
    """Empty dense caches (``CACHE_DTYPE``; recurrent states keep their
    own dtype) for ``plan.particles`` stacked particles of ``params``:
    under a model axis a Group of each position's caches and states (the
    layout ``models.tp.prefill`` makes, ``tp.cache_init``)."""
    if isinstance(params, Group):
        return tp.cache_init(params, cfg, plan.particles, batch, seq_len,
                             dtype=CACHE_DTYPE)
    return api.init_cache(cfg, batch, seq_len, particles=plan.particles,
                          dtype=CACHE_DTYPE,
                          device=tree_leaves(params)[0].device)


def abstract_batch(cfg, shape, batch: int, device, init=None):
    """A batch of ``batch`` rows on ``device``: int32 tokens and labels;
    audio adds the frames and vlm the patches, in bf16 (the reference's
    stub frontends). Empty (fake) tensors unless ``init``, a generator the
    values are drawn from."""
    out = {"tokens": _ints(cfg, (batch, shape.seq_len), device, init),
           "labels": _ints(cfg, (batch, shape.seq_len), device, init)}

    def floats(*size):
        if init is None:
            return torch.empty(size, dtype=torch.bfloat16, device=device)
        return torch.randn(size, generator=init, device=init.device).to(
            device=device, dtype=torch.bfloat16)

    if cfg.family == "audio":
        out["frames"] = floats(batch, cfg.n_frames, cfg.d_model)
    if cfg.family == "vlm":
        out["patches"] = floats(batch, cfg.n_prefix_tokens, cfg.d_model)
    return out


def _ints(cfg, size, device, init):
    """int32 tokens of ``size``: empty (fake) unless ``init``, a generator
    they are drawn from."""
    if init is None:
        return torch.empty(size, dtype=torch.int32, device=device)
    return torch.randint(0, cfg.vocab_size, size, generator=init,
                         device=init.device).to(torch.int32).to(device)


# --------------------------------------------------------------------------
# the reference's sharding specs, as tuples of axis names
# --------------------------------------------------------------------------

def _div(n: int, mesh, axis: str) -> bool:
    size = mesh.shape.get(axis, 1)
    return n % size == 0 and n >= size


def batch_specs(cfg, plan: RunPlan, mesh, batch_abs):
    """The reference's batch specs: the batch over ``data`` when the
    batch owns it (serving), else replicated; the frontend's float inputs
    may also take ``model``."""
    multi = "pod" in mesh.shape
    if plan.particle_axis is None:
        bspec = ("pod", "data") if multi else ("data",)
    else:
        bspec = ("pod",) if multi else (None,)

    def fit(n, axes):
        out, prod = [], 1
        for ax in axes:
            if ax is None:
                continue
            if n % (prod * mesh.shape[ax]) == 0:
                out.append(ax)
                prod *= mesh.shape[ax]
        if not out:
            return None
        return tuple(out) if len(out) > 1 else out[0]

    specs = {}
    for k, v in batch_abs.items():
        if k in ("tokens", "labels"):
            specs[k] = (fit(v.shape[0], bspec),)
        else:
            specs[k] = (fit(v.shape[0], tuple(bspec) + ("model",)), None,
                        None)
    return specs


def cache_specs(cfg, plan: RunPlan, mesh, cache_abs, batch: int):
    """The reference's sequence-sharded cache specs (B -> data where it
    divides, the cache's sequence or a state's heads -> model), one tuple
    a leaf of ``cache_abs`` (a tree, or a Group's first shard). The port
    places caches by kv head instead (module docstring)."""
    if isinstance(cache_abs, Group):
        cache_abs = cache_abs.shards[0]
    b_ax = "data" if _div(batch, mesh, "data") else None
    leaves, unflatten = tree_flatten(cache_abs)
    specs = []
    for (path, leaf) in rules.named_leaves(cache_abs):
        nd = len(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        model = lambda n: "model" if _div(n, mesh, "model") else None
        if name in ("k", "v"):
            tail = (b_ax, model(leaf.shape[-3]), None, None)
        elif name == "pos":
            tail = (b_ax, model(leaf.shape[-1]))
        elif name in ("xk", "xv"):
            tail = (b_ax, None, None, None)
        elif name in ("ssm", "state"):
            tail = (b_ax, model(leaf.shape[-3]), None, None)
        elif name == "conv":
            tail = (b_ax, None, None)
        elif name.startswith("x_last"):
            tail = (b_ax, None)
        else:
            tail = (None,) * nd
        specs.append((None,) * (nd - len(tail)) + tail)
    return unflatten(specs)


def residual_policy(cfg, plan: RunPlan, mesh):
    """The reference's activation policy for full-sequence passes
    (Megatron-SP style), its specs as tuples. The port's ``maybe_shard``
    records shapes under it and constrains nothing."""
    multi = "pod" in mesh.shape
    if plan.particle_axis is None:
        b = ("pod", "data") if multi else "data"
        moe_c = "data"
    else:
        b = "pod" if multi else None
        moe_c = None
    return {
        "__mesh__": dict(mesh.shape),
        "residual": (b, "model", None),
        "logits": (b, None, "model"),
        "moe_buffer": ("model", moe_c, None),
        "moe_tokens": (moe_c, None),
        "attn_heads": (b, None, "model", None),
        "attn_kv": (b, None, "model", None),
        "ssm_heads": (b, None, "model", None),
    }


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def _rows(batch) -> int:
    return next(iter(batch.values())).shape[0]


def microbatched_grads(cfg, plan: RunPlan):
    """``f(params, batch) -> (losses (P,), grads)``: one backward per
    microbatch slice (``plan.microbatches`` equal slices of the batch's
    rows), the grads accumulated in fp32 and averaged, the losses
    averaged (the reference's scan). The slices' loop is
    ``obs.device.trips``: a loop-aware count runs one slice."""
    vag = functional.ensemble_value_and_grad(
        lambda p, b: api.loss_fn(p, b, cfg))
    mb = plan.microbatches

    def grads(params, batch):
        if mb == 1:
            return vag(params, batch)
        n = _rows(batch) // mb
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        first = tree_leaves(params)[0]
        total = torch.zeros(first.shape[:1], device=first.device)
        for i in obs.trips(mb):
            loss, g = vag(params, {k: v[i * n:(i + 1) * n]
                                   for k, v in batch.items()})
            acc = tree_map(lambda a, x: a + x.float(), acc, g)
            total = total + loss
        return total / mb, tree_map(lambda a: a / mb, acc)

    return grads


def _update(opt, params, grads, opt_state):
    """The optimizer's update per model shard: (new params, new state)."""
    grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
    outs = [opt.update(p, g, s) for p, g, s, _ in
            functional.per_shard(params, grads, opt_state, None)]
    if isinstance(params, Group):
        return (params.like(o[0] for o in outs),
                opt_state.like(o[1] for o in outs))
    return outs[0]


def make_train_step(cfg, plan: RunPlan, mesh):
    """``step(params, opt_state, batch) -> (params, opt_state, losses)``:
    the particles' grads over the microbatches, then ``optim.make``'s
    update (new trees, as the reference's step returns)."""
    opt = make_optimizer(cfg.optimizer, 1e-3)
    grads_fn = microbatched_grads(cfg, plan)
    policy = residual_policy(cfg, plan, mesh)

    def step(params, opt_state, batch):
        with activation_policy(policy):
            losses, grads = grads_fn(params, batch)
            new_p, new_s = _update(opt, params, grads, opt_state)
        return new_p, new_s, losses

    return step


def _as_group(tree):
    if isinstance(tree, Group):
        return tree
    dims = {p: None for p, _ in rules.named_leaves(tree)}
    return Group([tree], dims, [tree_leaves(tree)[0].device])


def _owned_matrix(group: Group, j: int):
    """Position j's (rows, D_j) fp32 block of the flattened particles, in
    ``ravel_pytree``'s column order (``bdl.svgd._owned``)."""
    leaves = svgd_mod._owned(group.shards[j], group.dims, j)
    n = leaves[0].shape[0]
    return torch.cat([x.reshape(n, -1).float() for x in leaves], 1)


def make_svgd_train_step(cfg, plan: RunPlan, mesh, lr: float = 1e-3,
                         lengthscale: float = 1.0):
    """``step(params, batch, peers=None) -> (params, losses)``: the
    particles' grads over the microbatches, then the RBF force over all
    P particles (#1 and #2, ``bdl.svgd.svgd_phi_spec``'s body) and theta
    - lr * phi for this position's rows. ``peers`` (a pair of lists, one
    (P - rows, D_j) fp32 block a model position: the other data
    positions' theta and grads) is the gather over ``data``
    (``bdl.svgd._MeshStep``), charged as an "all-gather" where it lands;
    None when one data position holds every particle."""
    grads_fn = microbatched_grads(cfg, plan)
    force = svgd_mod.svgd_phi_spec(lengthscale).make(None)
    policy = residual_policy(cfg, plan, mesh)

    def step(params, batch, peers=None):
        with activation_policy(policy):
            losses, grads = grads_fn(params, batch)
        group, ggroup = _as_group(params), _as_group(grads)
        devices = group.devices
        theta, g = [], []
        for j, d in enumerate(devices):
            t, gj = _owned_matrix(group, j), _owned_matrix(ggroup, j)
            if peers is not None:
                t = torch.cat([t, obs.moved(peers[0][j], d, "all-gather")])
                gj = torch.cat([gj, obs.moved(peers[1][j], d, "all-gather")])
            theta.append(t)
            g.append(gj)
        rows = tree_leaves(group.shards[0])[0].shape[0]
        mask = torch.ones(theta[0].shape[0], device=devices[0])
        phi = Group([torch.empty_like(t) for t in theta], None, devices)
        force(Group(theta, None, devices), Group(g, None, devices), mask, phi)
        shards = []
        for j, shard in enumerate(group.shards):
            paths = [p for p, _ in rules.named_leaves(shard, sort_keys=True)
                     if group.dims[p] is not None or j == 0]
            owned = svgd_mod._owned(shard, group.dims, j)
            cols = phi.shards[j][:rows].split(
                [x[0].numel() for x in owned], dim=1)
            new = {p: x - lr * c.reshape(x.shape).to(x.dtype)
                   for p, x, c in zip(paths, owned, cols)}
            shards.append(new)
        first = shards[0]
        out = []
        for j, (shard, d) in enumerate(zip(group.shards, devices)):
            leaves, unflatten = tree_flatten(shard)
            out.append(unflatten([
                shards[j][p] if p in shards[j] else first[p].to(d)
                for p, _ in rules.named_leaves(shard)]))
        new_params = group.like(out) if isinstance(params, Group) else out[0]
        return new_params, losses

    return step


def make_multiswag_train_step(cfg, plan: RunPlan, mesh):
    """``step(params, opt_state, swag_state, batch) -> (params, opt_state,
    swag_state, losses)``: the train step, then one SWAG collection of
    the new params (#3, ``bdl.swag.swag_collect``, in place on each
    shard's state)."""
    base = make_train_step(cfg, plan, mesh)

    def step(params, opt_state, swag_state, batch):
        new_p, new_s, losses = base(params, opt_state, batch)
        for sw, p, _ in functional.per_shard(swag_state, new_p, None):
            swag_collect(sw, p)
        return new_p, new_s, swag_state, losses

    return step


def _ensemble(plan: RunPlan, logits):
    """The serve ensemble's logits: the mean over the particles in fp32
    (P > 1), else the one particle's."""
    if plan.particles > 1:
        return logits.float().mean(0)
    return logits[0]


def make_prefill_step(cfg, plan: RunPlan, mesh):
    """``step(params, batch) -> (logits, caches)``: ``api.prefill`` (#5 on
    the card)."""
    policy = residual_policy(cfg, plan, mesh)

    def step(params, batch):
        with activation_policy(policy):
            logits, caches = api.prefill(params, batch, cfg)
        return _ensemble(plan, logits), caches

    return step


def make_serve_step(cfg, plan: RunPlan, mesh):
    """``step(params, token, caches, cur_pos) -> (logits, caches)``:
    ``api.decode_step`` (#6 on the card), the caches in place."""
    policy = residual_policy(cfg, plan, mesh)

    def step(params, token, caches, cur_pos):
        with activation_policy(policy):
            logits, caches = api.decode_step(params, token, caches, cur_pos,
                                             cfg)
        return _ensemble(plan, logits), caches

    return step


# --------------------------------------------------------------------------
# top level: one data position's step and inputs
# --------------------------------------------------------------------------

def _specs(tree, plan: RunPlan, mesh):
    if isinstance(tree, Group):
        tree = tree.shards[0]
    return rules.tree_param_specs(tree, "tp", plan.particle_axis,
                                  mesh_shape=dict(mesh.shape))


def build(cfg, shape, plan: RunPlan, mesh, bdl: str = "ensemble", *,
          init: Optional[torch.Generator] = None):
    """(step, args, placement) at data position 0 of ``mesh``: ``args``
    fake (made under a ``FakeTensorMode`` that ``launch.cost`` enters),
    or real and drawn from ``init`` on the mesh's devices. ``bdl`` picks
    the train step ("ensemble", "svgd", "multiswag"). ``placement``
    holds the reference's specs of each argument (``specs``), the
    cache's layout (``kv_layout``) and the local sizes."""
    if plan.mode == "fsdp_tp":
        raise NotImplementedError(
            f"{cfg.name} runs P={plan.particles} in mode 'fsdp_tp' (FSDP "
            "over data + TP over model): the port places 'tp' plans only "
            "(ROADMAP.md queue 1, item 29)")
    if "pod" in mesh.shape:
        raise NotImplementedError(
            "a multi-pod mesh needs the multi-host bring-up "
            "(ROADMAP.md queue 1, item 10c)")
    cfg = cfg.replace(remat=(shape.kind == "train"), dtype="bfloat16")
    if init is None:
        with FakeTensorMode(allow_non_fake_inputs=True):
            return _build(cfg, shape, plan, mesh, bdl, None)
    return _build(cfg, shape, plan, mesh, bdl, init)


def _build(cfg, shape, plan, mesh, bdl, init):
    P, B = local_sizes(plan, shape, mesh)
    devices = _group_devices(mesh)
    params = abstract_params(cfg, plan, P, mesh, init)
    p_specs = _specs(params, plan, mesh)
    place_info = {"kv_layout": "heads", "particles": P, "batch": B,
                  "mesh": dict(mesh.shape)}
    if shape.kind == "train":
        if bdl in ("svgd", "multiswag") and plan.particles < 2:
            raise ValueError(f"{bdl} needs a particle axis (P>1); "
                             f"{cfg.name} runs P={plan.particles}")
        batch = abstract_batch(cfg, shape, B, devices[0], init)
        b_specs = batch_specs(cfg, plan, mesh, batch)
        if bdl == "svgd":
            peers = None
            if P < plan.particles:
                peers = _peers(params, plan.particles - P, mesh, init)
            step = make_svgd_train_step(cfg, plan, mesh)
            return step, (params, batch, peers), dict(
                place_info, specs=(p_specs, b_specs, None))
        opt = abstract_opt_state(cfg, plan, params)
        o_specs = _specs(opt, plan, mesh)
        if bdl == "multiswag":
            sw = abstract_swag_state(params)
            step = make_multiswag_train_step(cfg, plan, mesh)
            return step, (params, opt, sw, batch), dict(
                place_info, specs=(p_specs, o_specs, _specs(sw, plan, mesh),
                                   b_specs))
        step = make_train_step(cfg, plan, mesh)
        return step, (params, opt, batch), dict(
            place_info, specs=(p_specs, o_specs, b_specs))
    if shape.kind == "prefill":
        batch = abstract_batch(cfg, shape, B, devices[0], init)
        batch.pop("labels")
        step = make_prefill_step(cfg, plan, mesh)
        return step, (params, batch), dict(
            place_info, specs=(p_specs, batch_specs(cfg, plan, mesh, batch)))
    # decode: one new token against a seq_len cache
    cache = abstract_cache(cfg, plan, params, B, shape.seq_len)
    token = _ints(cfg, (B,), devices[0], init)
    pos = torch.zeros((), dtype=torch.int32, device=devices[0])
    step = make_serve_step(cfg, plan, mesh)
    t_spec = ("data" if _div(shape.global_batch, mesh, "data") else None,)
    return step, (params, token, cache, pos), dict(
        place_info, specs=(p_specs, t_spec,
                           cache_specs(cfg, plan, mesh, cache,
                                       shape.global_batch), ()))


def _peers(params, rows: int, mesh, init):
    """The other data positions' (rows, D_j) fp32 theta and grad blocks,
    one a model position of data position 0, on data position 1's
    devices (where the gather reads them from)."""
    group = _as_group(params)
    src = list(mesh.devices[1].flat) if mesh.devices.ndim > 1 else \
        [mesh.devices.flat[1]]
    widths = [sum(x[0].numel() for x in svgd_mod._owned(s, group.dims, j))
              for j, s in enumerate(group.shards)]
    make = torch.empty if init is None else torch.zeros
    return tuple([make((rows, w), dtype=torch.float32, device=d)
                  for w, d in zip(widths, src)] for _ in range(2))
