"""End-to-end fmax pipeline vs the reference's shipped Fmax PDF.

Oracle: HMF_Validation/pinocchio.test.FmaxPDF.out (128^3, EH, sigma8=0.8).
The realizations differ (threefry vs GSL seed plane) so agreement is
statistical: bin-wise at the few-percent level, collapsed fraction <1%.
"""

import numpy as np
import pytest


def test_smoothing_ladder(hmf_validation_params, hmf_validation_cosmology):
    from pinocchio_jax.fmax import Smoothing
    sm = Smoothing.build(hmf_validation_params, hmf_validation_cosmology)
    # reference log: 9 radii, R = 20.636 ... 0.259, 0
    assert sm.n == 9
    ref_radii = [20.636, 13.996, 9.026, 5.466, 3.058, 1.548, 0.689, 0.259, 0.0]
    np.testing.assert_allclose(sm.radii, ref_radii, atol=2e-3)
    np.testing.assert_allclose(sm.variance[0], 0.078961, rtol=1e-4)
    np.testing.assert_allclose(sm.variance[-1], 10.4775, rtol=1e-3)


def test_sigma_self_consistency(fmax_result):
    """computed sigma vs linear theory per radius (fmax.c:143-146)."""
    sm = fmax_result.smoothing
    for i in range(sm.n - 2):      # last radii suffer grid discreteness
        exp_s = np.sqrt(sm.variance[i])
        got_s = np.sqrt(sm.true_variance[i])
        assert abs(got_s / exp_s - 1.0) < 0.25, (i, exp_s, got_s)


def test_fmax_pdf_vs_reference(fmax_result, reference_file):
    ref = np.loadtxt(reference_file(
        "HMF_Validation/pinocchio.test.FmaxPDF.out"))[:, 2]
    F = np.asarray(fmax_result.products.Fmax).ravel()
    xF = np.clip((F * 10).astype(int), 0, 209)
    mine = np.bincount(xF, minlength=210).astype(float)

    # collapsed fraction to z=0
    coll_mine = mine[10:].sum()
    coll_ref = ref[10:].sum()
    assert abs(coll_mine / coll_ref - 1.0) < 0.02

    # bins with decent statistics agree to ~5%
    for i in range(1, 100):
        if ref[i] > 5000:
            assert abs(mine[i] / ref[i] - 1.0) < 0.05, (i, mine[i], ref[i])


def test_displacement_field_statistics(fmax_result,
                                       hmf_validation_cosmology):
    """Zel'dovich rms displacement vs the Parseval sum over the REALIZED
    spectrum — deterministic, fp32-roundoff tight (the loose factor-2
    theory window moved to test_lpt_oracle.py with a proper
    noise-adaptive tolerance; per-mode exactness is asserted there too)."""
    g = fmax_result.grid
    N = g.N
    v1 = np.asarray(fmax_result.products.vel["v1"]).astype(np.float64)
    kden = np.asarray(fmax_result.kdensity)
    m = np.arange(N)
    m = np.where(m <= N // 2, m, m - N)
    kx = (2 * np.pi / N) * m.reshape(N, 1, 1)
    ky = (2 * np.pi / N) * m.reshape(1, N, 1)
    kz = (2 * np.pi / N) * np.arange(N // 2 + 1).reshape(1, 1, -1)
    k2 = kx * kx + ky * ky + kz * kz
    inv = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    mz = np.arange(N // 2 + 1).reshape(1, 1, -1)
    w = np.broadcast_to(np.where((mz > 0) & (mz < N // 2), 2.0, 1.0),
                        kden.shape)
    amp2 = np.abs(kden.astype(np.complex128)) ** 2 * w / float(N) ** 6
    for a, ka in enumerate((kx, ky, kz)):
        var_expect = (amp2 * ka * ka * inv * inv).sum()
        var_got = (v1[a] ** 2).mean()
        assert abs(var_got / var_expect - 1.0) < 0.01, a

    # 2LPT/3LPT fields must be much smaller than Zel'dovich
    rms_axis = np.sqrt((v1 ** 2).mean())
    v2 = np.asarray(fmax_result.products.vel["v2"])
    assert np.sqrt((v2 ** 2).mean()) < 0.5 * rms_axis


@pytest.mark.parametrize("R", [0.0, 2.0])
def test_hessian_matches_float64_reference(hmf_validation_params,
                                           hmf_validation_cosmology, R):
    """The six Hessian components of the FFT path (derivatives.
    second_derivatives) against an independent float64 numpy transform,
    unsmoothed and smoothed."""
    import dataclasses

    import jax.numpy as jnp
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    from pinocchio_jax.ops import derivatives

    N = 32
    p = dataclasses.replace(hmf_validation_params, GridSize=N)
    grid = Grid(N=N, BoxSize=p.BoxSize_htrue)
    kden = generate_kdensity(grid, hmf_validation_cosmology, p.RandomSeed)
    sd = np.asarray(derivatives.second_derivatives(kden, jnp.float32(R), N))
    k = 2.0 * np.pi / N * np.fft.fftfreq(N, 1.0 / N)
    kz = 2.0 * np.pi / N * np.arange(N // 2 + 1)
    kv = (k[:, None, None], k[None, :, None], kz[None, None, :])
    k2 = kv[0] ** 2 + kv[1] ** 2 + kv[2] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(k2 > 0, np.exp(-0.5 * k2 * R * R) / k2, 0.0)
    base = np.asarray(kden).astype(np.complex128) * w
    for c, (a, b) in enumerate(derivatives.SECOND_DERIV_PAIRS):
        ref = np.fft.irfftn(base * kv[a] * kv[b], s=(N, N, N),
                            axes=(0, 1, 2))
        assert np.abs(sd[c] - ref).max() / np.abs(ref).max() < 1e-5, c
