"""Fused MultiSWAG on the port's recurrent LMs (zamba2-1.2b, rwkv6-7b)
against the JAX package, on the CPU: 2 particles of the reference's
init at each arch's ``smoke()`` size, 2 epochs of
``tests/test_torch_recurrent_train.py``'s loader with sgd 0.05,
collecting after each epoch (rank 2). The losses, the params and each
particle's SWAG mean within 1e-4 of the reference's compiled run.
"""
import pytest

from test_torch_recurrent_lm import (  # noqa: F401 (autouse fixture)
    ARCHS, _one_thread)
from test_torch_recurrent_train import _flat_torch, _ref, _run

@pytest.mark.parametrize("name", ARCHS)
def test_multiswag_matches_jax(name):
    talgo = _run(name, "multiswag")
    for pid, jmean in zip(talgo.push_dist.particle_ids(),
                          _ref(name, "multiswag")[2]):
        tsw = talgo.push_dist.particles[pid].state["swag"]
        assert int(tsw["rank"]) == 2
        assert abs(_flat_torch(tsw["mean"]) - jmean).max() < 1e-4
    talgo.cleanup()
