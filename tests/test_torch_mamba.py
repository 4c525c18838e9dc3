"""The port's Mamba2 block (``repro_torch.models.mamba``) against the JAX
package's, on the CPU.

Both packages run the same weights: the reference's ``mamba_init`` for
each of P = 2 particles, carried over as numpy. Inputs are made from a
seed with numpy. At ``tests/test_moe_ssm.py``'s MAMBA_CFG (d_model 32,
d_state 8, head_dim 16: 4 heads), checks:

  * ``mamba_block_full`` (chunks 8 and 64), ``mamba_ref`` and a
    prefill-then-decode against the reference's, at lengths 21 and 37
    (both pad the last chunk): outputs and states within 1e-5;
  * the split with state carry (two ``mamba_block_full`` calls, the
    second from the first's state) against the reference's, 1e-5;
  * the grads of every leaf and of the input, 1e-4 relative;
  * within the port, chunked against stepwise and decode against the
    full pass, at the reference's own 1e-3;
  * the masked pairs' exponents: at a steep decay the reference's
    chunked grads are NaN (``where`` after ``exp`` of ``inf``), the
    port's finite and equal to its stepwise oracle's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import mamba as jmamba
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import mamba as tmamba

P, B = 2, 2
FIELDS = dict(name="t", family="hybrid", d_model=32, vocab_size=10,
              ssm_state=8, ssm_head_dim=16, ssm_expand=2)
JCFG, TCFG = JConfig(**FIELDS), TConfig(**FIELDS)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's many small ops: on a shared CPU
    a pool of threads waits on its slowest member (steps of 0.1 s took up
    to 10 s with 8 threads). Values do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _params(seed=0, **set_to):
    """P particles of the reference's init (numpy, stacked), with the
    leaves in ``set_to`` filled with a constant."""
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    p = jax.tree.map(np.asarray, jax.vmap(
        lambda k: jmamba.mamba_init(k, JCFG))(keys))
    for k, v in set_to.items():
        p[k] = np.full_like(p[k], v)
    return p


def _x(S, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (P, B, S, FIELDS["d_model"])) * 0.5).astype(np.float32)


@functools.partial(jax.jit, static_argnums=2)
def _jax_full(p, x, chunk, st=None):
    if st is None:
        return jax.vmap(lambda pp, xx: jmamba.mamba_block_full(
            pp, xx, JCFG, chunk=chunk))(p, x)
    return jax.vmap(lambda pp, xx, s: jmamba.mamba_block_full(
        pp, xx, JCFG, chunk=chunk, st=s))(p, x, st)


_jax_ref = jax.jit(jax.vmap(lambda pp, xx: jmamba.mamba_ref(pp, xx, JCFG)))
_jax_decode = jax.jit(jax.vmap(lambda pp, xx, s: jmamba.mamba_block_decode(
    pp, xx, JCFG, s)))


def _close(got, want, tol, what):
    got = jax.tree.leaves(jax.tree.map(np.asarray, got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        assert np.abs(g - w).max() < tol, (what, np.abs(g - w).max())


def _port(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("S", [21, 37])
def test_block_full_matches_jax(S, chunk):
    p, x = _params(), _x(S)
    jy, jst = _jax_full(p, x, chunk)
    ty, tst = tmamba.mamba_block_full(params_from_numpy(p),
                                      torch.from_numpy(x), TCFG, chunk=chunk)
    _close(ty.numpy(), jy, 1e-5, "out")
    _close(_port(tst), jst, 1e-5, "state")


@pytest.mark.parametrize("S", [21, 37])
def test_stepwise_oracle_matches_jax(S):
    p, x = _params(), _x(S)
    want = _jax_ref(p, x)
    got = tmamba.mamba_ref(params_from_numpy(p), torch.from_numpy(x), TCFG)
    _close(got.numpy(), want, 1e-5, "mamba_ref")


@pytest.mark.parametrize("S", [21, 37])
def test_prefill_then_decode_matches_jax(S):
    """A prefill of S - 4 tokens, then 4 decode steps from its state:
    every step's output and state against the reference's."""
    p, x = _params(), _x(S)
    tp = params_from_numpy(p)
    _, jst = _jax_full(p, x[:, :, :S - 4], 64)
    _, tst = tmamba.mamba_block_full(tp, torch.from_numpy(x[:, :, :S - 4]),
                                     TCFG)
    for t in range(S - 4, S):
        jo, jst = _jax_decode(p, x[:, :, t:t + 1], jst)
        to, tst = tmamba.mamba_block_decode(
            tp, torch.from_numpy(x[:, :, t:t + 1]), TCFG, tst)
        _close(to.numpy(), jo, 1e-5, ("out", t))
        _close(_port(tst), jst, 1e-5, ("state", t))


@pytest.mark.parametrize("split", [6, 13])
def test_split_with_state_carry_matches_jax(split):
    p, x = _params(), _x(21)
    tp = params_from_numpy(p)
    _, js = _jax_full(p, x[:, :, :split], 8)
    jy, jst = _jax_full(p, x[:, :, split:], 8, st=js)
    _, ts = tmamba.mamba_block_full(tp, torch.from_numpy(x[:, :, :split]),
                                    TCFG, chunk=8)
    ty, tst = tmamba.mamba_block_full(tp, torch.from_numpy(x[:, :, split:]),
                                      TCFG, chunk=8, st=ts)
    _close(ty.numpy(), jy, 1e-5, "out")
    _close(_port(tst), jst, 1e-5, "state")
    full, _ = tmamba.mamba_block_full(tp, torch.from_numpy(x), TCFG, chunk=8)
    head, _ = tmamba.mamba_block_full(tp, torch.from_numpy(x[:, :, :split]),
                                      TCFG, chunk=8)
    assert torch.cat([head, ty], 2).sub(full).abs().max() < 1e-3


@pytest.mark.parametrize("S", [21, 37])
def test_grads_match_jax(S):
    """Grads of a weighted sum of the output and of the final ssm state,
    for every leaf and for the input, within 1e-4 relative."""
    p, x = _params(), _x(S)
    wy = np.random.default_rng(3).standard_normal(
        (P, B, S, FIELDS["d_model"])).astype(np.float32)

    def jloss(pp, xx):
        y, st = jax.vmap(lambda a, b: jmamba.mamba_block_full(
            a, b, JCFG, chunk=8))(pp, xx)
        return (y * wy).sum() + st["ssm"].sum()

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), params_from_numpy(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, st = tmamba.mamba_block_full(tp, tx, TCFG, chunk=8)
    ((y * torch.from_numpy(wy)).sum() + st["ssm"].sum()).backward()
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(), tp))):
        assert _rel(got, np.asarray(want)) < 1e-4, path
    assert _rel(tx.grad.numpy(), np.asarray(jgx)) < 1e-4


@pytest.mark.parametrize("S", [21, 37])
def test_chunked_matches_stepwise_and_decode(S):
    """Within the port: chunked (chunk 8) against the stepwise oracle, and
    S decode steps from an empty state against the full pass, at the
    reference's own 1e-3."""
    tp, x = params_from_numpy(_params()), torch.from_numpy(_x(S))
    full, _ = tmamba.mamba_block_full(tp, x, TCFG, chunk=8)
    assert (full - tmamba.mamba_ref(tp, x, TCFG)).abs().max() < 1e-3
    st = tmamba.mamba_state_init(TCFG, P, B, dtype=torch.float32,
                                 device="cpu")
    outs = []
    for t in range(S):
        o, st = tmamba.mamba_block_decode(tp, x[:, :, t:t + 1], TCFG, st)
        outs.append(o)
    assert (torch.cat(outs, 2) - full).abs().max() < 1e-3


def test_steep_decay_grads_stay_finite():
    """dt_bias 10 and A_log 3 make a step's log decay about -200, so a
    chunk's masked pairs reach exponents past fp32's range: the
    reference's chunked grads are NaN there; the port masks the exponent
    first, and its grads equal its stepwise oracle's."""
    p, x = _params(dt_bias=10.0, A_log=3.0), _x(21)

    def jloss(pp):
        return jax.vmap(lambda a, b: jmamba.mamba_block_full(
            a, b, JCFG, chunk=8)[0])(pp, x).sum()

    jg = jax.jit(jax.grad(jloss))(p)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jg))
    grads = []
    for fn in (lambda tp, tx: tmamba.mamba_block_full(tp, tx, TCFG,
                                                      chunk=8)[0],
               lambda tp, tx: tmamba.mamba_ref(tp, tx, TCFG)):
        tp = jax.tree.map(lambda t: t.requires_grad_(True),
                          params_from_numpy(p))
        fn(tp, torch.from_numpy(x)).sum().backward()
        grads.append(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tp)))
    for g, r in zip(*grads):
        assert bool(torch.isfinite(g).all())
        assert (g - r).abs().max() <= 1e-3 * max(float(r.abs().max()), 1.0)
