"""paligemma-3b's prefix-LM (family "vlm") on the port against the JAX
package, on the CPU.

The prefix-LM mask (key j visible to query i iff j <= i or j <
prefix_len: the stub image patches are seen bidirectionally, the text
causally):

  * ``blocks.flash_attention(kind="prefix")``, forward and backward,
    against the reference's jnp form at 2e-5, with ``prefix_len`` not a
    multiple of the chunk and with padded queries; with a softcap (the
    forward differentiated by autograd);
  * ``kernels.ref.flash_attention(prefix_len=)`` (#5's plain version)
    against the reference's jnp form at 2e-5, and at ``prefix_len`` 0
    against the Pallas kernel in interpret mode;

and the model at ``smoke()`` size (2 layers, d_model 128, 4 heads over 1
kv head of 32, 8 stub patches, vocab 512), 2 particles of the
reference's init, with ``tests/test_torch_encdec.py``'s checks: the
configs, ``make_batch``'s patches, the tree, ``loss_fn`` and grads,
``prefill`` and decode against the reference (its caches hold absolute
positions that count the patches), the stateful engine, a fused
DeepEnsemble epoch, the model axis against the one-device port and the
refusals; also the prefill-then-decode continuation: a prefill of the
prompt and k more tokens against k decode steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jattention
from repro.models import blocks as jblocks
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ref as kref
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from test_torch_encdec import (  # noqa: F401 (autouse fixture)
    S, _cfgs, _offset, _one_thread, _serve_batch, _stacked, _torch,
    batches_match, config_fields_match, engine_matches,
    fused_training_matches, init_tree_matches, loss_and_grads_match,
    prefill_and_decode_match, refusals)

NAME = "paligemma-3b"


def _qkv(seed, Sq, H, KVH, hd, P=2, B=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((P, B, Sq, h, hd)).astype(np.float32)
            for h in (H, KVH, KVH, H)]


# (Sq, heads, kv heads, hd, prefix_len, q_chunk, k_chunk): prefixes off
# the chunk grid, padded queries and keys, the whole sequence a prefix
PREFIX_GRID = [
    (13, 4, 2, 8, 5, 4, 8),
    (13, 4, 1, 16, 9, 8, 4),
    (20, 2, 2, 8, 7, 6, 6),
    (11, 4, 2, 8, 11, 4, 4),
    (16, 8, 1, 32, 3, 16, 16),
]


@pytest.mark.parametrize("Sq,H,KVH,hd,prefix,qc,kc", PREFIX_GRID)
def test_chunked_prefix_flash_and_grads_match_jax(Sq, H, KVH, hd, prefix,
                                                  qc, kc):
    q, k, v, do = _qkv(Sq + prefix, Sq, H, KVH, hd)
    kw = dict(kind="prefix", prefix_len=prefix, q_chunk=qc, k_chunk=kc)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tblocks.flash_attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    for p in range(q.shape[0]):
        jout, vjp = jax.vjp(lambda a, b, c: jblocks.flash_attention(
            a, b, c, **kw), jnp.asarray(q[p]), jnp.asarray(k[p]),
            jnp.asarray(v[p]))
        assert np.abs(tout[p].detach().numpy() - np.asarray(jout)).max() \
            < 2e-5
        for got, want in zip(tgrads, vjp(jnp.asarray(do[p]))):
            assert np.abs(got[p].numpy() - np.asarray(want)).max() < 2e-5
    # #5's plain version computes the same function
    plain = kref.flash_attention(*(t.detach() for t in (tq, tk, tv)),
                                 causal=True, prefix_len=prefix)
    assert (tout.detach() - plain).abs().max() < 2e-5


def test_chunked_prefix_flash_with_softcap_matches_jax():
    q, k, v, do = _qkv(3, 13, 4, 2, 8)
    kw = dict(kind="prefix", prefix_len=6, q_chunk=4, k_chunk=8,
              softcap=3.0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tblocks.flash_attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    for p in range(q.shape[0]):
        jout, vjp = jax.vjp(lambda a, b, c: jblocks.flash_attention(
            a, b, c, **kw), jnp.asarray(q[p]), jnp.asarray(k[p]),
            jnp.asarray(v[p]))
        assert np.abs(tout[p].detach().numpy() - np.asarray(jout)).max() \
            < 2e-5
        for got, want in zip(tgrads, vjp(jnp.asarray(do[p]))):
            assert np.abs(got[p].numpy() - np.asarray(want)).max() < 2e-5


@pytest.mark.parametrize("prefix", [0, 1, 5, 17, 24])
@pytest.mark.parametrize("H,KVH,hd", [(4, 2, 16), (8, 1, 32)])
def test_plain_kernel_prefix_matches_jax(H, KVH, hd, prefix):
    """#5's plain version under the prefix-LM mask against the
    reference's jnp prefix flash attention (a prefix of S sees every
    key); at ``prefix_len`` 0 also against the Pallas kernel. A prefix
    past S is left out: the reference's chunked form then also lets the
    queries see its zero-padded keys."""
    S_ = 24
    q, k, v, _ = _qkv(prefix + hd, S_, H, KVH, hd)
    got = kref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, prefix_len=prefix).numpy()
    for p in range(q.shape[0]):
        args = [jnp.asarray(a[p]) for a in (q, k, v)]
        want = np.asarray(jblocks.flash_attention(
            *args, kind="prefix", prefix_len=prefix, q_chunk=8, k_chunk=16))
        assert np.abs(got[p] - want).max() < 2e-5
        if prefix == 0:
            pallas = np.asarray(jattention.flash_attention(
                *args, causal=True, q_block=8, k_block=8))
            assert np.abs(got[p] - pallas).max() < 2e-5
        if prefix >= S_:
            bidir = np.asarray(jblocks.flash_attention(*args, kind="bidir"))
            assert np.abs(got[p] - bidir).max() < 2e-5


# ---------------------------------------------------------------------------
# paligemma-3b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_match_jax(smoke):
    config_fields_match(NAME, smoke)


def test_make_batch_patches_identical():
    batches_match(NAME)


def test_init_tree_matches_jax():
    init_tree_matches(NAME)


def test_loss_and_grads_match_jax():
    loss_and_grads_match(NAME)


def test_prefill_and_decode_match_jax():
    prefill_and_decode_match(NAME, steps=3)


def test_prefill_then_decode_continuation():
    """A prefill of the prompt and k more tokens against the prompt's
    prefill and k decode steps over those tokens: the last logits within
    1e-4 of the largest (the patches sit at positions 0..7 in both)."""
    _, tcfg = _cfgs(NAME)
    params = params_from_numpy(_stacked(NAME))
    batch = _torch(_serve_batch(NAME, 9, S + 3))
    off, k = _offset(tcfg), 3
    full, _ = tapi.prefill(params, batch, tcfg)
    short = {**batch, "tokens": batch["tokens"][:, :S]}
    logits, caches = tapi.prefill(params, short, tcfg, max_len=off + S + k)
    for i in range(k):
        logits, caches = tapi.decode_step(
            params, batch["tokens"][:, S + i], caches, off + S + i, tcfg)
    assert (logits - full).abs().max() < 1e-4 * full.abs().max()
    assert int(caches["units"][0]["pos"].max()) == off + S + k - 1


def test_stateful_engine_matches_jax_engine():
    engine_matches(NAME)


def test_fused_ensemble_matches_jax():
    fused_training_matches(NAME, "ensemble")


def test_refusals():
    refusals(NAME)
    _, tcfg = _cfgs(NAME)
    params = params_from_numpy(_stacked(NAME))
    batch = _torch(_serve_batch(NAME, 0, 4))
    # max_len counts the patches
    with pytest.raises(ValueError, match="max_len"):
        tapi.prefill(params, batch, tcfg, max_len=4)
