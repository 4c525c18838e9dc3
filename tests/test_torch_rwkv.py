"""The port's RWKV6 block (``repro_torch.models.rwkv``) against the JAX
package's, on the CPU.

Both packages run the same weights: the reference's ``rwkv_init`` for
each of P = 2 particles, carried over as numpy. Inputs are made from a
seed with numpy. At ``tests/test_moe_ssm.py``'s RWKV_CFG (d_model 64,
head_dim 16: 4 heads, d_ff 128), checks:

  * ``time_mix_chunked`` (chunks 8 and 32), ``time_mix_ref``,
    ``channel_mix``, ``rwkv_block_full`` and a prefill-then-decode
    (``rwkv_block_decode``) against the reference's, at lengths 21 and
    37 (both pad the last chunk): outputs and states within 1e-5;
  * the split with state carry (``time_mix_chunked`` from the first
    part's state and last token) against the reference's, 1e-5;
  * the grads of every leaf and of the input, 1e-4 relative;
  * within the port, chunked against stepwise and decode against the
    full pass, at the reference's own 1e-3;
  * the masked pairs' exponents: at a steep decay the reference's
    chunked grads are NaN, the port's finite and equal to its stepwise
    oracle's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import rwkv as jrwkv
from repro.models.blocks import norm_apply as jnorm
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import rwkv as trwkv
from repro_torch.models.blocks import norm_apply as tnorm

P, B = 2, 2
FIELDS = dict(name="t", family="ssm", d_model=64, vocab_size=10,
              rwkv_head_dim=16, d_ff=128)
JCFG, TCFG = JConfig(**FIELDS), TConfig(**FIELDS)
D = FIELDS["d_model"]



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


def _params(seed=0, w0=None):
    """P particles of the reference's init (numpy, stacked); ``w0`` fills
    the base log-log decay."""
    keys = jax.random.split(jax.random.PRNGKey(seed), P)
    p = jax.tree.map(np.asarray, jax.vmap(
        lambda k: jrwkv.rwkv_init(k, JCFG))(keys))
    if w0 is not None:
        p["time_mix"]["w0"] = np.full_like(p["time_mix"]["w0"], w0)
    return p


def _x(S, seed=1):
    return (np.random.default_rng(seed).standard_normal((P, B, S, D))
            * 0.5).astype(np.float32)


@functools.partial(jax.jit, static_argnums=2)
def _jax_tm(tm, x, chunk, state=None, x_last=None):
    return jax.vmap(lambda a, b, s, xl: jrwkv.time_mix_chunked(
        a, b, JCFG, state=s, x_last=xl, chunk=chunk))(tm, x, state, x_last)


_jax_tm_ref = jax.jit(jax.vmap(lambda a, b: jrwkv.time_mix_ref(a, b, JCFG)))
_jax_full = jax.jit(jax.vmap(lambda a, b: jrwkv.rwkv_block_full(a, b, JCFG)))
_jax_decode = jax.jit(jax.vmap(lambda a, b, s: jrwkv.rwkv_block_decode(
    a, b, JCFG, s)))
_jax_cm = jax.jit(jax.vmap(lambda a, b: jrwkv.channel_mix(a, b)))


def _close(got, want, tol, what):
    got = jax.tree.leaves(jax.tree.map(np.asarray, got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        assert np.abs(g - w).max() < tol, (what, np.abs(g - w).max())


def _port(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


def _normed(p, x):
    """ln1 of x, by each package (the time-mix input)."""
    return (np.asarray(jax.vmap(jnorm)(p["ln1"], x)),
            tnorm(params_from_numpy(p["ln1"]), torch.from_numpy(x)))


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("S", [21, 37])
def test_time_mix_chunked_matches_jax(S, chunk):
    p = _params()
    jx, tx = _normed(p, _x(S))
    jy, jst = _jax_tm(p["time_mix"], jx, chunk)
    ty, tst = trwkv.time_mix_chunked(params_from_numpy(p["time_mix"]), tx,
                                     TCFG, chunk=chunk)
    _close(ty.numpy(), jy, 1e-5, "out")
    _close(_port(tst), jst, 1e-5, "state, x_last")


@pytest.mark.parametrize("S", [21, 37])
def test_stepwise_oracle_and_channel_mix_match_jax(S):
    p = _params()
    jx, tx = _normed(p, _x(S))
    want = _jax_tm_ref(p["time_mix"], jx)
    got = trwkv.time_mix_ref(params_from_numpy(p["time_mix"]), tx, TCFG)
    _close(got.numpy(), want, 1e-5, "time_mix_ref")
    want = _jax_cm(p["channel_mix"], jx)
    got = trwkv.channel_mix(params_from_numpy(p["channel_mix"]), tx)
    _close(_port(got), want, 1e-5, "channel_mix")


@pytest.mark.parametrize("S", [21, 37])
def test_prefill_then_decode_matches_jax(S):
    """``rwkv_block_full`` over S - 4 tokens, then 4 decode steps from its
    state: every output and state against the reference's."""
    p, x = _params(), _x(S)
    tp = params_from_numpy(p)
    jy, jst = _jax_full(p, x[:, :, :S - 4])
    ty, tst = trwkv.rwkv_block_full(tp, torch.from_numpy(x[:, :, :S - 4]),
                                    TCFG)
    _close(ty.numpy(), jy, 1e-5, "prefill out")
    _close(_port(tst), jst, 1e-5, "prefill state")
    for t in range(S - 4, S):
        jo, jst = _jax_decode(p, x[:, :, t:t + 1], jst)
        to, tst = trwkv.rwkv_block_decode(
            tp, torch.from_numpy(x[:, :, t:t + 1]), TCFG, tst)
        _close(to.numpy(), jo, 1e-5, ("out", t))
        _close(_port(tst), jst, 1e-5, ("state", t))


@pytest.mark.parametrize("split", [6, 13])
def test_split_with_state_carry_matches_jax(split):
    p = _params()
    jx, tx = _normed(p, _x(21))
    tm = params_from_numpy(p["time_mix"])
    _, (js, jl) = _jax_tm(p["time_mix"], jx[:, :, :split], 8)
    jy, jst = _jax_tm(p["time_mix"], jx[:, :, split:], 8, js, jl)
    _, (ts, tl) = trwkv.time_mix_chunked(tm, tx[:, :, :split], TCFG, chunk=8)
    ty, tst = trwkv.time_mix_chunked(tm, tx[:, :, split:], TCFG, state=ts,
                                     x_last=tl, chunk=8)
    _close(ty.numpy(), jy, 1e-5, "out")
    _close(_port(tst), jst, 1e-5, "state")
    full, _ = trwkv.time_mix_chunked(tm, tx, TCFG, chunk=8)
    assert (full[:, :, split:] - ty).abs().max() < 1e-3


@pytest.mark.parametrize("S", [21, 37])
def test_grads_match_jax(S):
    """Grads of a weighted sum of the block's output and of its final
    time-mix state, for every leaf and for the input, within 1e-4
    relative."""
    p, x = _params(), _x(S)
    wy = np.random.default_rng(3).standard_normal((P, B, S, D)).astype(
        np.float32)

    def jloss(pp, xx):
        y, st = jax.vmap(lambda a, b: jrwkv.rwkv_block_full(
            a, b, JCFG, chunk=8))(pp, xx)
        return (y * wy).sum() + st["state"].sum()

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), params_from_numpy(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, st = trwkv.rwkv_block_full(tp, tx, TCFG, chunk=8)
    ((y * torch.from_numpy(wy)).sum() + st["state"].sum()).backward()
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(), tp))):
        assert _rel(got, np.asarray(want)) < 1e-4, path
    assert _rel(tx.grad.numpy(), np.asarray(jgx)) < 1e-4


@pytest.mark.parametrize("S", [21, 37])
def test_chunked_matches_stepwise_and_decode(S):
    """Within the port: chunked (chunk 8) against the stepwise oracle,
    and S decode steps from an empty state against the full block, at
    the reference's own 1e-3."""
    p, x = _params(), _x(S)
    tp, tx = params_from_numpy(p), torch.from_numpy(x)
    xn = tnorm(tp["ln1"], tx)
    y, _ = trwkv.time_mix_chunked(tp["time_mix"], xn, TCFG, chunk=8)
    assert (y - trwkv.time_mix_ref(tp["time_mix"], xn, TCFG)).abs().max() \
        < 1e-3
    full, _ = trwkv.rwkv_block_full(tp, tx, TCFG, chunk=8)
    st = trwkv.rwkv_state_init(TCFG, P, B, dtype=torch.float32,
                               device="cpu")
    outs = []
    for t in range(S):
        o, st = trwkv.rwkv_block_decode(tp, tx[:, :, t:t + 1], TCFG, st)
        outs.append(o)
    assert (torch.cat(outs, 2) - full).abs().max() < 1e-3


def test_steep_decay_grads_stay_finite():
    """w0 4 makes a channel's log decay about -e^4 = -55 a step, so a
    chunk's masked pairs reach exponents past fp32's range: the
    reference's chunked grads are NaN there; the port masks the exponent
    first, and its grads equal its stepwise oracle's."""
    p = _params(w0=4.0)
    jx, tx = _normed(p, _x(21))

    def jloss(tm):
        return _jax_tm(tm, jx, 8)[0].sum()

    jg = jax.jit(jax.grad(jloss))(p["time_mix"])
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jg))
    grads = []
    for fn in (lambda tm: trwkv.time_mix_chunked(tm, tx, TCFG, chunk=8)[0],
               lambda tm: trwkv.time_mix_ref(tm, tx, TCFG)):
        tm = jax.tree.map(lambda t: t.requires_grad_(True),
                          params_from_numpy(p["time_mix"]))
        fn(tm).sum().backward()
        grads.append(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tm)))
    for g, r in zip(*grads):
        assert bool(torch.isfinite(g).all())
        assert (g - r).abs().max() <= 1e-3 * max(float(r.abs().max()), 1.0)
