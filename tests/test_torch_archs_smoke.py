"""Every config of the registry on the port against the JAX package, on
the CPU: the port's counterpart of ``tests/test_archs_smoke.py``.

For each of the twelve names of the reference's ``configs.ALL``, at
``smoke()`` size, one particle of the reference's init (carried over as
numpy) on the reference's smoke batch:

  * a train step: the port's loss within 1e-5 of the reference's
    (relative), the grads finite, one Adam update, the new loss finite;
  * for the families that decode (all but vision and pde), two decode
    steps from an empty ``init_cache``: logits finite and within 1e-4 of
    the reference's largest logit.

And the registry: ``ARCHS``, ``PAPER_WORKLOADS``, ``ALL``, ``SKIPS``,
``is_skipped`` and the four ``INPUT_SHAPES`` equal the reference's, key
for key and field for field; ``get`` of an unknown name raises the
reference's KeyError.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.core.functional import ensemble_value_and_grad
from repro_torch.core.tree import tree_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.optim import adam
from test_archs_smoke import _smoke_batch
from test_torch_recurrent_lm import _one_thread  # noqa: F401 (autouse)

ARCH_IDS = sorted(jconfigs.ALL)
DECODERS = [a for a in ARCH_IDS
            if jconfigs.ALL[a].family not in ("vision", "pde")]


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The reference's smoke params for one particle, as numpy with a
    leading particle axis of 1."""
    sc = jconfigs.get(arch).smoke()
    params = jax.jit(lambda k: japi.init_params(k, sc))(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a)[None], params)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_matches_jax(arch):
    jsc, tsc = jconfigs.get(arch).smoke(), tconfigs.get(arch).smoke()
    batch = jax.tree.map(np.asarray, _smoke_batch(jsc))
    jparams = jax.tree.map(lambda a: jnp.asarray(a[0]), _init(arch))
    jloss = float(jax.jit(lambda p: japi.loss_fn(p, batch, jsc)[0])(jparams))
    params = params_from_numpy(_init(arch))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, grads = ensemble_value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tsc))(params, tb)
    assert loss.shape == (1,)
    assert torch.isfinite(loss).all(), f"{arch}: non-finite loss"
    assert _rel(loss.numpy(), np.array([jloss])) < 1e-5
    gn = sum(float(g.square().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gn), f"{arch}: non-finite grads"
    opt = adam(1e-3)
    state = opt.init(params)
    new_params, _ = opt.update(params, grads, state)
    l2, _ = tapi.loss_fn(new_params, tb, tsc)
    assert torch.isfinite(l2).all()


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    """The reference's two decode steps from an empty cache (B 2, 16
    slots): each step's logits."""
    jsc = jconfigs.get(arch).smoke()
    params = jax.tree.map(lambda a: jnp.asarray(a[0]), _init(arch))
    step = jax.jit(lambda p, c, pos: japi.decode_step(
        p, jnp.ones((2,), jnp.int32), c, pos, jsc))
    cache, out = japi.init_cache(jsc, 2, 16), []
    for pos in range(2):
        logits, cache = step(params, cache, jnp.int32(pos))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_smoke_decode_step_matches_jax(arch):
    tsc = tconfigs.get(arch).smoke()
    params = params_from_numpy(_init(arch))
    cache = tapi.init_cache(tsc, 2, 16, particles=1, device="cpu")
    for pos, want in enumerate(_jax_decode(arch)):
        logits, cache = tapi.decode_step(
            params, torch.ones(2, dtype=torch.int32), cache, pos, tsc)
        assert logits.shape == (1, 2, tsc.vocab_size)
        assert torch.isfinite(logits).all(), f"{arch}: decode NaN"
        assert np.abs(logits[0].numpy() - want).max() \
            < 1e-4 * np.abs(want).max()


def test_registry_matches_jax():
    for name in ("ARCHS", "PAPER_WORKLOADS", "ALL"):
        got, want = getattr(tconfigs, name), getattr(jconfigs, name)
        assert list(got) == list(want), name
        for arch in want:
            t, j = got[arch], want[arch]
            for f in dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), (arch,
                                                                  f.name)
    assert tconfigs.SKIPS == jconfigs.SKIPS
    for arch in jconfigs.ALL:
        for shape in jconfigs.INPUT_SHAPES:
            assert tconfigs.is_skipped(arch, shape) == \
                jconfigs.is_skipped(arch, shape)
    assert list(tconfigs.INPUT_SHAPES) == list(jconfigs.INPUT_SHAPES)
    for key, want in jconfigs.INPUT_SHAPES.items():
        assert dataclasses.asdict(tconfigs.INPUT_SHAPES[key]) == \
            dataclasses.asdict(want)
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tconfigs, name)) == \
            dataclasses.asdict(getattr(jconfigs, name))
    for mod in (tconfigs, jconfigs):
        with pytest.raises(KeyError) as err:
            mod.get("no-such-arch")
        assert "unknown arch 'no-such-arch'" in str(err.value)
