"""The dry run's count (``repro_torch.launch.cost``, ``obs.device``) and
the kernel wrappers' fake forms, on the CPU (port only).

  * each of the eight kernel wrappers on fake tensors (the dry run's
    card, ``kernels.build.on_card``) gives the plain version's output
    shapes and dtypes, charges exactly its own ``cost(...)`` to its
    device, and launches nothing; a real meta tensor still raises;
  * loop awareness (the counterpart of ``tests/test_launch.py::
    test_hlo_cost_trip_counts``): 7 trips of an 8 x 8 x 8 product count
    7 x its FLOPs, and a smoke train step at 4 microbatches counts, one
    trip multiplied, exactly what running every trip counts; remat's
    recompute is inside the count;
  * per device: at model 2 the dense smoke train step's product FLOPs on
    position 1 are half of model 1's within 1%, position 0's within 5%
    (it recomputes the MLP's down projection under remat, which the
    checkpoint's early stop skips at the last position: 2% more at smoke
    width), and position 0's "all-reduce" bytes equal the
    ``tp.reduce_sum`` calls times their bytes;
  * a stack counted from 1 and 2 units (``cost.extrapolate``) equals the
    trace of every unit exactly (FLOPs, bytes, collectives, argument and
    output bytes).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.kernels import (decode_attention, flash_attention, ops, ref,
                                 paged_decode_attention,
                                 paged_decode_window_attention, svgd_rbf,
                                 swag_moments)
from repro_torch.launch import cost as C
from repro_torch.launch import make_mesh, steps as TS
from repro_torch.launch.plans import plan_for
from repro_torch.models import tp
from repro_torch.obs import device as obs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_cases():
    """(name, ops dispatch, its wrapper's cost, args maker, plain)."""
    P, B, H, KVH, hd, C_, W = 2, 3, 4, 2, 16, 24, 3
    i32 = torch.int32

    def attn(f, *shapes):
        return [f(s) for s in shapes]

    return [
        ("flash", lambda a: ops.flash_attention(*a),
         lambda a: flash_attention.cost(*a),
         lambda f: attn(f, (P, B, 8, H, hd), (P, B, 8, KVH, hd),
                        (P, B, 8, KVH, hd)), ref.flash_attention),
        ("decode", lambda a: ops.decode_attention(*a),
         lambda a: decode_attention.cost(*a),
         lambda f: attn(f, (P, B, H, hd), (P, B, C_, KVH, hd),
                        (P, B, C_, KVH, hd)) + [f((B, C_), i32)],
         ref.decode_attention),
        ("paged", lambda a: ops.paged_decode_attention(*a),
         lambda a: paged_decode_attention.cost(*a),
         lambda f: attn(f, (P, B, H, hd), (P, 9, 4, KVH, hd),
                        (P, 9, 4, KVH, hd)) + [f((B, 2), i32), f((B,), i32)],
         ref.paged_decode_attention),
        ("window", lambda a: ops.paged_decode_window_attention(*a),
         lambda a: paged_decode_window_attention.cost(*a),
         lambda f: attn(f, (P, B, W, H, hd), (P, 9, 4, KVH, hd),
                        (P, 9, 4, KVH, hd)) + [f((B, 2), i32), f((B,), i32)],
         ref.paged_decode_window_attention),
        ("sqdist", lambda a: ops.pairwise_sqdist(*a),
         lambda a: svgd_rbf.sqdist_cost(a[0]),
         lambda f: [f((5, 40))], ref.pairwise_sqdist),
        ("force", lambda a: ops.svgd_force(*a),
         lambda a: svgd_rbf.force_cost(a[0]),
         lambda f: [f((5, 40)), f((5, 40)), f((5, 5)), f((5,)), f((1,))],
         ref.svgd_force),
    ]


def _values(shape, dtype=torch.float32):
    if dtype == torch.int32:
        return torch.randint(0, 2, shape, dtype=dtype)
    return torch.rand(shape, dtype=dtype)


@pytest.mark.parametrize("case", [c[0] for c in _kernel_cases()])
def test_kernel_fake_form(case):
    name, call, cost, make, plain = next(c for c in _kernel_cases()
                                         if c[0] == case)
    want = plain(*make(_values))
    launches = [f.launches for f in ops.COUNTED]
    dev = torch.device("meta", 3)
    with FakeTensorMode():
        args = make(lambda s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                            device=dev))
        with obs.counting(dry_run=True) as count:
            out = call(args)
        assert (count.flops, count.bytes) == cost(args)
        assert set(count.devices) == {3}
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.device == dev
    assert [f.launches for f in ops.COUNTED] == launches
    with pytest.raises(ValueError, match="no .* for device meta"):
        call(make(lambda s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                          device="meta")))


def test_swag_fake_forms_charge_and_update_in_place():
    shapes = [(2, 3, 5), (2, 7), (2, 1)]
    cpu_means = [torch.rand(s) for s in shapes]
    want = ref.diag_std_leaves(cpu_means, [m * m + 1 for m in cpu_means])
    launches = [f.launches for f in ops.COUNTED]
    dev = torch.device("meta", 1)
    with FakeTensorMode():
        z = [torch.zeros(s, device=dev) for s in shapes]
        sq = [torch.zeros(s, device=dev) for s in shapes]
        th = [torch.zeros(s, device=dev) for s in shapes]
        ring = [torch.zeros((2, 4) + s[1:], device=dev) for s in shapes]
        n = torch.zeros(2, device=dev)
        slot = torch.zeros(2, dtype=torch.int32, device=dev)
        with obs.counting() as count:
            means, sqs = ops.swag_moments_leaves(z, sq, th, n, None, ring,
                                                 slot)
        assert means is z and sqs is sq
        assert (count.flops, count.bytes) == tuple(map(sum, zip(*(
            swag_moments.moments_cost(m, d) for m, d in zip(z, ring)))))
        with obs.counting() as count:
            scales = ops.diag_std_leaves(z, sq)
        assert (count.flops, count.bytes) == tuple(map(sum, zip(*(
            swag_moments.diag_std_cost(m) for m in z))))
    assert [s.shape for s in scales] == [w.shape for w in want]
    assert all(s.dtype == torch.float32 and s.device == dev for s in scales)
    assert [f.launches for f in ops.COUNTED] == launches


def test_loop_trips_multiply_the_body():
    dev = TS.trace_devices(1)[0]
    with FakeTensorMode():
        x = torch.empty((8, 8), device=dev)
        w = torch.empty((8, 8), device=dev)

    def step(x, w):
        for _ in obs.trips(7):
            x = x @ w
        return x

    c = C.cost(step, x, w)
    assert c["flops"] == 2 * 8 * 8 * 8 * 7
    assert C.cost(step, x, w, trips=False)["flops"] == c["flops"]


def _smoke(units=2, **kw):
    cfg = configs.get("qwen1.5-0.5b").smoke().replace(n_units=units)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=32,
                                global_batch=8)
    plan = dataclasses.replace(plan_for(configs.get("qwen1.5-0.5b"),
                                        INPUT_SHAPES["train_4k"]),
                               particles=2, **kw)
    return cfg, shape, plan


def _mesh(m):
    return make_mesh((1, m), ("data", "model"), TS.trace_devices(m))


def test_microbatch_loop_counts_every_trip():
    cfg, shape, plan = _smoke(microbatches=4)
    step, args, _ = TS.build(cfg, shape, plan, _mesh(1))
    aware = C.cost(step, *args)
    every = C.cost(step, *args, trips=False)
    assert aware["flops"] == every["flops"] > 0
    assert aware["bytes"] == every["bytes"]
    # remat's recompute is counted: more than the same step without it
    plain = TS.make_train_step(cfg.replace(dtype="bfloat16"), plan, _mesh(1))
    assert C.cost(plain, *args)["flops"] < aware["flops"]


def test_model_axis_halves_products_and_charges_reduce_sum(monkeypatch):
    cfg, shape, plan = _smoke(microbatches=1)
    one = C.cost(*_flat(TS.build(cfg, shape, plan, _mesh(1))))
    calls = []
    real = tp.reduce_sum

    def counted(parts, devices):
        if obs.counting_now():
            calls.append(parts[1].numel() * parts[1].element_size())
        return real(parts, devices)

    monkeypatch.setattr(tp, "reduce_sum", counted)
    two = C.cost(*_flat(TS.build(cfg, shape, plan, _mesh(2))))
    second = C.cost(*_flat(TS.build(cfg, shape, plan, _mesh(2))), device=1)
    assert abs(second["flops"] / one["flops"] - 0.5) < 0.01
    assert abs(two["flops"] / one["flops"] - 0.5) < 0.05
    assert calls and two["coll"]["all-reduce"] == sum(calls) // 2
    assert "all-reduce" not in one["coll"]


def _flat(built):
    step, args, _ = built
    return (step, *args)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_extrapolated_stack_equals_every_unit(shape):
    cfg, _, plan = _smoke(units=4, microbatches=2)
    shp = dataclasses.replace(INPUT_SHAPES[shape], seq_len=32,
                              global_batch=8)
    if shape == "decode_32k":
        plan = dataclasses.replace(plan, microbatches=1, particle_axis=None)
    every, _ = C.count(cfg, shp, plan, _mesh(2), every_unit=True)
    ext, _ = C.count(cfg, shp, plan, _mesh(2))
    assert ext["units"] == 4 and "units" not in every
    for key in ("flops", "bytes", "coll"):
        assert ext[key] == every[key], key
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert ext["memory"][key] == every["memory"][key], key
    assert sorted(C.top_collectives(ext)) == sorted(C.top_collectives(every))
