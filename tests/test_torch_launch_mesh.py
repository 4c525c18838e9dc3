"""The port's device mesh (``repro_torch.launch.mesh``) and ``Placement``
record against the reference's, on the CPU.

Counterparts of ``tests/test_launch.py``'s mesh tests: the four
validation errors, the 2D ``(data, model)`` axes and
``pick_model_axis``'s budget table, value for value against the
reference's function. A ``devices=`` list stands in for the reference's
forced host devices (and may repeat one device). Then the ``Placement``
record: equality by plan, ``auto`` with a model axis, the axis sizes
and the layouts it describes.
"""
import itertools

import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.core.store import Placement
from repro_torch.launch import make_bench_mesh, make_mesh, pick_model_axis

CPU4 = ["cpu"] * 4


def test_make_bench_mesh_rejects_non_divisible_model():
    with pytest.raises(ValueError, match="does not divide"):
        make_bench_mesh(4, model=5, devices=CPU4)
    with pytest.raises(ValueError, match="positive"):
        make_bench_mesh(4, model=0, devices=CPU4)


def test_make_mesh_rejects_oversized_shape():
    with pytest.raises(ValueError, match="needs 5 devices but only 4"):
        make_mesh((5,), ("data",), devices=CPU4)
    with pytest.raises(ValueError, match="disagree"):
        make_mesh((1, 1), ("data",), devices=CPU4)
    with pytest.raises(ValueError, match="non-positive"):
        make_mesh((0, 1), ("data", "model"), devices=CPU4)
    with pytest.raises(ValueError, match="not a multiple of 3"):
        make_mesh((3,), ("data",), devices=CPU4)
    # no device list: the visible CUDA devices (none here)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} are visible"):
        make_mesh((n + 1,), ("data",))
    # valid submesh shapes build, on the first devices of the list
    mesh = make_mesh((1, 1), ("data", "model"), devices=CPU4)
    assert mesh.size == 1 and mesh.flat_devices() == [torch.device("cpu")]


def test_make_bench_mesh_2d_axes():
    mesh = make_bench_mesh(4, model=1, devices=CPU4)
    assert tuple(mesh.axis_names) == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices.shape == (4, 1)
    assert mesh.flat_devices() == [torch.device("cpu")] * 4
    m2 = make_bench_mesh(4, model=2, devices=CPU4)
    assert m2.shape == {"data": 2, "model": 2}


def test_pick_model_axis_budget():
    # no memory info / no params -> particle-parallel (model=1)
    assert pick_model_axis(0, 8) == 1
    assert pick_model_axis(100, 8, device_memory_bytes=None) == 1
    assert pick_model_axis(100, 8, device_memory_bytes=1000) == 1
    assert pick_model_axis(1000, 8, device_memory_bytes=1000) == 2
    assert pick_model_axis(2300, 8, device_memory_bytes=1000) == 4
    assert pick_model_axis(10**9, 8, device_memory_bytes=1000) == 8


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_pick_model_axis_equals_the_reference(n):
    for pb, mem, frac in itertools.product(
            (0, 1, 100, 599, 600, 601, 1000, 2300, 4999, 10**9),
            (None, 1000, 4096), (0.6, 0.25)):
        assert pick_model_axis(pb, n, device_memory_bytes=mem,
                               fraction=frac) == jmesh.pick_model_axis(
            pb, n, device_memory_bytes=mem, fraction=frac), (pb, n, mem)


def test_placement_plan_equality_and_refusals():
    a = Placement(mesh=make_bench_mesh(4, devices=CPU4))
    b = Placement(mesh=make_bench_mesh(4, devices=CPU4))
    assert a == b and hash(a) == hash(b) and a.plan_key() == b.plan_key()
    assert a != Placement(mesh=make_bench_mesh(2, devices=CPU4[:2]))
    assert a != Placement() and Placement() == Placement(mesh=None)
    assert a != Placement(mesh=a.mesh, mode="dp")
    assert a.particle_axis_size() == 4 and a.model_axis_size() == 1
    # positions key the plan: the same device at another position is
    # another plan, on the card's logical positions as on real ones
    assert a.plan_key()[0][2] == tuple(("cpu", None, i) for i in range(4))
    # the model axis: a particle across a model group of positions
    two = Placement(mesh=make_bench_mesh(4, model=2, devices=CPU4))
    assert two.particle_axis_size() == 2 and two.model_axis_size() == 2
    assert two != a and two == Placement(
        mesh=make_bench_mesh(4, model=2, devices=CPU4))
    assert len(two.groups()) == 2 and all(len(g) == 2 for g in two.groups())
    assert dict(Placement.auto(model=2, devices=CPU4).mesh.shape) == {
        "data": 2, "model": 2}
    # 2000 bytes against 60% of 1000: a shard fits at model = 4
    auto = Placement.auto(model="auto", params_bytes=2000,
                          device_memory_bytes=1000, devices=CPU4)
    assert dict(auto.mesh.shape) == {"data": 1, "model": 4}
    assert auto.activation_policy()["__mesh__"] == {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="mode 'tp'"):
        Placement(mesh=two.mesh, mode="dp")


def test_placement_auto_and_layouts():
    # no CUDA device here: one device or none -> mesh=None
    assert Placement.auto() == Placement(mesh=None)
    assert Placement.auto(devices=["cpu"]) == Placement(mesh=None)
    pl = Placement.auto(devices=CPU4, model="auto", params_bytes=100,
                        device_memory_bytes=10**6)
    assert pl.mesh.shape == {"data": 4, "model": 1}
    # the precision-aware estimate: bf16 masters count 2 bytes a float
    tree = {"w": torch.zeros(10, 10), "i": torch.zeros(3, dtype=torch.int32)}
    assert Placement.auto(devices=CPU4, model="auto", param_tree=tree,
                          precision="bf16",
                          device_memory_bytes=1000) == pl
    assert pl.spmd_axis(8) == "data" and pl.spmd_axis(6) is None
    cpu = torch.device("cpu")
    assert pl.vector(8) == tuple((i, cpu, slice(2 * i, 2 * i + 2))
                                 for i in range(4))
    assert pl.vector(2) is None            # the axis does not divide 2
    assert pl.matrix(8, 10) == pl.vector(8)
    assert pl.shardings({"w": torch.zeros(4, 3)}) == pl.vector(4)
    assert pl.gathered_matrix(10) == ((0, cpu, slice(None)),)
    assert Placement().vector(8) is None and Placement().positions() == []
