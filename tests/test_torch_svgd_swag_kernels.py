"""The plain versions of the port's SVGD and SWAG kernels against the JAX
package, on the CPU (the CUDA kernels themselves are held against these
plain versions on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Inputs come from numpy with a seed; the Pallas kernels run in interpret
mode, as ``tests/test_kernels.py`` runs them. Tolerances are the
reference's own:

  * ``pairwise_sqdist`` on the ``test_kernels.py`` sweep against
    ``ref.pairwise_sqdist`` and the Pallas kernel, 1e-3 absolute; masked,
    with NaN in the dead rows, against the reference's masked form;
  * the SVGD force (the entry point, and the plain versions composed by
    hand) against the reference's ``ref.svgd_force``, its Pallas kernel
    and its ``bdl.svgd.svgd_force(use_kernel=False)``, dense and masked
    (NaN in dead rows), at ell 1.0, 0.0 and -1.0 (the median heuristic,
    over live pairs when masked): 2e-4 relative;
  * SWAG moments against ``moments_flat`` (Pallas) and
    ``_update_moments_ref``, with a count per row, dead rows unchanged
    and the deviation ring written at each row's slot, 1e-5;
  * the diagonal scale against ``diag_std_flat`` (Pallas), 1e-5;
  * the dispatch: CPU tensors take the plain version, the CUDA wrappers
    refuse them without counting a launch, other devices raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bdl import svgd as jsvgd
from repro.bdl.swag import _update_moments_ref
from repro.kernels import ref as jref
from repro.kernels import svgd_rbf as jsvgd_rbf
from repro.kernels import swag_moments as jswag_moments
from repro_torch.bdl import svgd as tsvgd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import svgd_rbf as tsvgd_rbf
from repro_torch.kernels import swag_moments as tswag_moments

SQDIST_SWEEP = [(2, 16, 8), (4, 100, 32), (8, 5000, 2048), (64, 12345, 4096),
                (3, 7, 8)]
FORCE_SWEEP = [(4, 100, 32, 1.0), (8, 5000, 2048, 1.3), (16, 50000, 8192, 0.7),
               (3, 7, 8, 2.0)]


def _theta(seed, n, D, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32) * scale,
            rng.standard_normal((n, D)).astype(np.float32))


def _mask(n, dead):
    m = np.ones(n, np.float32)
    m[list(dead)] = 0.0
    return m


def _with_nan(x, mask):
    x = x.copy()
    x[mask == 0] = np.nan
    return x


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-9)


@pytest.mark.parametrize("n,D,bd", SQDIST_SWEEP)
def test_sqdist_matches_jax(n, D, bd):
    t, _ = _theta(n * 7 + D, n, D)
    got = ops.pairwise_sqdist(torch.from_numpy(t))
    assert np.abs(got.numpy() - np.asarray(jref.pairwise_sqdist(t))).max() < 1e-3
    pallas = jsvgd_rbf.pairwise_sqdist(jnp.asarray(t), block_d=bd)
    assert np.abs(got.numpy() - np.asarray(pallas)).max() < 1e-3
    assert float(got.min()) >= 0.0


@pytest.mark.parametrize("n,D,dead", [(4, 100, [1]), (8, 5000, [0, 5, 7]),
                                      (3, 7, [2])])
def test_sqdist_masked_reads_dead_rows_as_zero(n, D, dead):
    t, _ = _theta(n + D, n, D)
    m = _mask(n, dead)
    got = ops.pairwise_sqdist(torch.from_numpy(_with_nan(t, m)),
                              torch.from_numpy(m))
    want = jref.pairwise_sqdist(jnp.where(m[:, None] > 0, t, 0.0))
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-3


@pytest.mark.parametrize("n,D,bd,ell", FORCE_SWEEP)
def test_force_matches_jax_dense(n, D, bd, ell):
    t, g = _theta(n * 11 + D, n, D, scale=0.05)
    got = tsvgd.svgd_force(torch.from_numpy(t), torch.from_numpy(g), ell)
    assert _rel(got, jref.svgd_force(t, g, ell)) < 2e-4
    assert _rel(got, jsvgd_rbf.svgd_force(jnp.asarray(t), jnp.asarray(g), ell,
                                          block_d=bd)) < 2e-4
    assert _rel(got, jsvgd.svgd_force(t, g, ell, use_kernel=False)) < 2e-4


@pytest.mark.parametrize("ell", [1.0, 0.0, -1.0])
@pytest.mark.parametrize("n,D,dead", [(4, 100, [2]), (8, 5000, [1, 6]),
                                      (16, 50000, [0, 3, 15]), (3, 7, []),
                                      (6, 33, [])])
def test_force_matches_jax_masked_and_median(n, D, dead, ell):
    """ell <= 0 is the median heuristic of the reference's jnp form (over
    live pairs when masked), not the Pallas path's raw ell."""
    t, g = _theta(n * 13 + D, n, D, scale=0.05)
    want = jsvgd.svgd_force(t, g, ell, use_kernel=False)
    got = tsvgd.svgd_force(torch.from_numpy(t), torch.from_numpy(g), ell)
    assert _rel(got, want) < 2e-4
    m = _mask(n, dead)
    want = jsvgd.svgd_force(_with_nan(t, m), _with_nan(g, m), ell,
                            use_kernel=False, mask=jnp.asarray(m))
    tt, tg, tm = (torch.from_numpy(x) for x in
                  (_with_nan(t, m), _with_nan(g, m), m))
    # the entry point, and the plain versions called past the dispatch
    plain = ref.svgd_force(tt, tg, *tsvgd.rbf_glue(
        ref.pairwise_sqdist(tt, tm), ell, tm), tm)
    for got in (tsvgd.svgd_force(tt, tg, ell, mask=tm), plain):
        assert torch.isfinite(got).all()
        assert _rel(got, want) < 2e-4
        assert float(got[torch.from_numpy(m) == 0].abs().sum()) == 0.0


def test_median_lengthscale_averages_the_middle_pair():
    t, _ = _theta(5, 4, 40)                    # 16 distances: an even count
    sq = ref.pairwise_sqdist(torch.from_numpy(t))
    want = jsvgd.rbf_lengthscale(jnp.asarray(t), 0.0)
    got = tsvgd.rbf_lengthscale(sq, 0.0)
    assert abs(float(got) - float(want)) < 1e-6 * float(want)
    assert float(tsvgd.rbf_lengthscale(sq, 1.5)) == 1.5


def _swag_case(seed, P, shape, R):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((P,) + shape).astype(np.float32)
    sq = mean ** 2 + np.abs(rng.standard_normal((P,) + shape)).astype(
        np.float32)
    theta = rng.standard_normal((P,) + shape).astype(np.float32)
    n = rng.integers(0, 6, P).astype(np.float32)
    dev = rng.standard_normal((P, R) + shape).astype(np.float32)
    rank = rng.integers(0, 9, P).astype(np.int32)
    return mean, sq, theta, n, dev, rank


@pytest.mark.parametrize("P,shape,dead", [(3, (123,), []), (4, (7, 3), [1]),
                                          (8, (8193,), [0, 5])])
def test_moments_match_jax(P, shape, dead):
    R = 4
    mean, sq, theta, n, dev, rank = _swag_case(P + len(shape), P, shape, R)
    m = _mask(P, dead)
    slot = (rank % R).astype(np.int32)
    tdev = torch.from_numpy(dev.copy())
    got_m, got_s = torch.from_numpy(mean.copy()), torch.from_numpy(sq.copy())
    ops.swag_moments_leaves(
        [got_m], [got_s], [torch.from_numpy(_with_nan(theta, m))],
        torch.from_numpy(n), torch.from_numpy(m), [tdev],
        torch.from_numpy(slot))
    for p in range(P):
        if m[p] == 0:       # dead rows: bit for bit, ring untouched
            assert np.array_equal(got_m[p].numpy(), mean[p])
            assert np.array_equal(got_s[p].numpy(), sq[p])
            assert np.array_equal(tdev[p].numpy(), dev[p])
            continue
        want_m, want_s = jswag_moments.moments_flat(
            mean[p].reshape(-1), sq[p].reshape(-1), theta[p].reshape(-1),
            n[p])
        ref_m, ref_s = _update_moments_ref(mean[p], sq[p], theta[p], n[p])
        for got, want in ((got_m[p], want_m), (got_m[p], ref_m),
                          (got_s[p], want_s), (got_s[p], ref_s)):
            assert np.abs(got.numpy().reshape(-1)
                          - np.asarray(want).reshape(-1)).max() < 1e-5
        others = [r for r in range(R) if r != slot[p]]
        assert np.array_equal(tdev[p, others].numpy(), dev[p, others])
        want_dev = theta[p] - np.asarray(ref_m)
        assert np.abs(tdev[p, slot[p]].numpy() - want_dev).max() < 1e-5


@pytest.mark.parametrize("D", [1, 123, 8192, 8193, 20000])
def test_diag_std_matches_jax(D):
    rng = np.random.default_rng(D)
    mean = rng.standard_normal((2, D)).astype(np.float32)
    sq = mean ** 2 + np.abs(rng.standard_normal((2, D))).astype(np.float32)
    sq[0, :D // 2] = 0.5 * mean[0, :D // 2] ** 2 - 1e-3    # clamped at 1e-30
    got = ops.diag_std_leaves([torch.from_numpy(mean)],
                              [torch.from_numpy(sq)])[0]
    for p in range(2):
        want = jswag_moments.diag_std_flat(mean[p], sq[p])
        assert np.abs(got[p].numpy() - np.asarray(want)).max() < 1e-5


def test_dispatch_has_no_other_branch():
    """CPU tensors take the plain versions; the CUDA wrappers refuse CPU
    tensors (they never fall back) and count no launch; other devices
    raise."""
    t = torch.ones(3, 8)
    m = torch.ones(3)
    cases = [
        (tsvgd_rbf.pairwise_sqdist, ops.pairwise_sqdist, (t,)),
        (tsvgd_rbf.svgd_force, ops.svgd_force,
         (t, t, torch.ones(3, 3), m, torch.ones(1))),
        (tswag_moments.moments_leaves, ops.swag_moments_leaves,
         ([t.clone()], [t.clone()], [t], m)),
        (tswag_moments.diag_std_leaves, ops.diag_std_leaves, ([t], [t])),
    ]
    meta = lambda a: ([x.to("meta") for x in a] if isinstance(a, list)
                      else a.to("meta"))
    for kernel, dispatch, args in cases:
        before = kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args)
        assert kernel.launches == before
        assert isinstance(dispatch(*args), (torch.Tensor, tuple, list))
        with pytest.raises(ValueError, match="device"):
            dispatch(*map(meta, args))
    before = tswag_moments.diag_std.launches       # the per-leaf probe
    with pytest.raises(ValueError, match="CUDA"):
        tswag_moments.diag_std(t, t)
    assert tswag_moments.diag_std.launches == before
