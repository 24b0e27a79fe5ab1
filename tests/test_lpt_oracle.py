"""Field-level IC / LPT oracles (reference methodology:
tests/ICs_piti_vs_pinocchio residual maps, SURVEY.md §4.5).

Unlike the statistical HMF/PDF tests, these assert PER-MODE equality of
the displacement products against an independent NumPy implementation of
the exact linear relations:

    v1_a  = D1  * irfft( i k_a / k^2 * delta(k) )
    v2_a  = D2  * irfft( i k_a / k^2 * rfft(source_2LPT) )
    v31/32 analogous with the 3LPT sources (LPT.c:70-141)

and the realized delta(k) spectrum against the input P(k).

Conventions under test (must match the reference):
  - k in grid units 2*pi*m/N with indices m > N/2 wrapped negative but
    m = N/2 kept POSITIVE ("ii > Nhalf" strictly, fmax-pfft.c:58-80)
  - c2r carries 1/N^3 (fmax-pfft.c:85), numpy's default
"""

import dataclasses

import numpy as np
import pytest


def _kvecs(N):
    """Reference k convention: +Nyquist (fmax-pfft.c:58-80)."""
    m = np.arange(N)
    m = np.where(m <= N // 2, m, m - N)
    kx = (2 * np.pi / N) * m.reshape(N, 1, 1)
    ky = (2 * np.pi / N) * m.reshape(1, N, 1)
    kz = (2 * np.pi / N) * np.arange(N // 2 + 1).reshape(1, 1, -1)
    return kx, ky, kz


def _inv_k2(kx, ky, kz):
    k2 = kx * kx + ky * ky + kz * kz
    return np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)


def _irfft(a, N):
    return np.fft.irfftn(a, s=(N, N, N), axes=(0, 1, 2))


@pytest.fixture(scope="module")
def oracle_run(hmf_validation_params, hmf_validation_cosmology):
    """Small fmax run + its host-side delta(k) for the numpy chains."""
    from pinocchio_jax.fmax import run_fmax
    p = dataclasses.replace(hmf_validation_params, GridSize=64)
    res = run_fmax(p, hmf_validation_cosmology, verbose=False)
    kden = np.asarray(res.kdensity).astype(np.complex128)
    return p, res, kden


def test_v1_per_mode_exact(oracle_run, hmf_validation_cosmology):
    """Zel'dovich field vs i k_a / k^2 delta(k): exact linear relation,
    fp32 roundoff only (VERDICT r2 item 6)."""
    p, res, kden = oracle_run
    cosmo = hmf_validation_cosmology
    N = p.GridSize
    v1 = np.asarray(res.products.vel["v1"])
    D1 = float(cosmo.GrowingMode(p.zlast, p.k_for_GM))
    kx, ky, kz = _kvecs(N)
    base = kden * 1j * _inv_k2(kx, ky, kz) * D1
    for a, ka in enumerate((kx, ky, kz)):
        expect = _irfft(base * ka, N)
        scale = np.abs(expect).max()
        assert np.abs(v1[a] - expect).max() < 1e-5 * scale, a


def test_lpt_orders_per_mode_exact(oracle_run, hmf_validation_cosmology):
    """2LPT + both 3LPT displacement stacks vs the full independent numpy
    chain (Hessian -> sources LPT.c:70-141 -> derivative), per mode."""
    p, res, kden = oracle_run
    cosmo = hmf_validation_cosmology
    N = p.GridSize
    kx, ky, kz = _kvecs(N)
    kv = (kx, ky, kz)
    inv = _inv_k2(kx, ky, kz)
    phi = kden * inv
    sd = {ab: _irfft(phi * kv[ab[0]] * kv[ab[1]], N)
          for ab in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))}
    src2 = (sd[(0, 0)] * sd[(1, 1)] + sd[(0, 0)] * sd[(2, 2)]
            + sd[(1, 1)] * sd[(2, 2)]
            - sd[(0, 1)] ** 2 - sd[(0, 2)] ** 2 - sd[(1, 2)] ** 2)
    src31 = 3.0 * (
        sd[(0, 0)] * (sd[(1, 1)] * sd[(2, 2)] - sd[(1, 2)] ** 2)
        - sd[(0, 1)] * (sd[(0, 1)] * sd[(2, 2)] - sd[(0, 2)] * sd[(1, 2)])
        + sd[(0, 2)] * (sd[(0, 1)] * sd[(1, 2)] - sd[(0, 2)] * sd[(1, 1)]))
    kv2 = np.fft.rfftn(src2)
    src32 = 2.0 * (sd[(0, 0)] + sd[(1, 1)] + sd[(2, 2)]) * src2
    base2 = kv2 * inv
    for (a, b), w in zip(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)),
                         (1, 1, 1, 2, 2, 2)):
        src32 = src32 - 2.0 * w * _irfft(base2 * kv[a] * kv[b], N) \
            * sd[(a, b)]
    sources = {"v2": (kv2, cosmo.GrowingMode_2LPT),
               "v31": (np.fft.rfftn(src31), cosmo.GrowingMode_3LPT_1),
               "v32": (np.fft.rfftn(src32), cosmo.GrowingMode_3LPT_2)}
    for key, (kvec, gm) in sources.items():
        got = np.asarray(res.products.vel[key])
        D = float(gm(p.zlast, p.k_for_GM))
        for a in range(3):
            expect = _irfft(kvec * 1j * kv[a] * inv * D, N)
            scale = np.abs(expect).max()
            assert np.abs(got[a] - expect).max() < 1e-5 * scale, (key, a)


def test_ic_realized_power_spectrum(oracle_run, hmf_validation_cosmology):
    """Binned P(k) of the realized delta(k) vs the input spectrum: each
    well-populated bin within ~4x its mode-count noise (the reference
    validates its IC product the same way, PK_Comparison in
    tests/pk_and_HMF_tests)."""
    p, res, kden = oracle_run
    cosmo = hmf_validation_cosmology
    N = p.GridSize
    Box = p.BoxSize_htrue
    m = np.arange(N)
    m = np.where(m <= N // 2, m, m - N).astype(float)
    mx = m.reshape(N, 1, 1)
    my = m.reshape(1, N, 1)
    mz = np.arange(N // 2 + 1).reshape(1, 1, -1).astype(float)
    mm = np.sqrt(mx * mx + my * my + mz * mz)
    # rfft half-space multiplicity
    w = np.broadcast_to(np.where((mz > 0) & (mz < N // 2), 2.0, 1.0),
                        kden.shape)
    P_real = np.abs(kden) ** 2 * Box ** 3 / float(N) ** 6
    kmag = (2 * np.pi / Box) * mm
    for lo, hi in ((6, 8), (10, 12), (14, 16), (20, 22), (26, 28)):
        sel = (mm >= lo) & (mm < hi) & (P_real > 0)
        nmod = w[sel].sum()
        pr = (P_real * w)[sel].sum() / nmod
        kc = (kmag * w)[sel].sum() / nmod
        pt = float(cosmo.PowerSpectrum(kc))
        tol = 4.0 / np.sqrt(nmod) + 0.02   # Exp(1) noise + binning bias
        assert abs(pr / pt - 1.0) < tol, (lo, hi, pr, pt)


def test_displacement_variance_parseval(oracle_run):
    """The realized per-axis displacement variance must equal the Parseval
    sum over the realized spectrum to fp32 roundoff — a deterministic
    whole-chain check (IC -> Green's function -> c2r), replacing the old
    factor-2 statistical window (VERDICT r2 weak #5)."""
    p, res, kden = oracle_run
    N = p.GridSize
    v1 = np.asarray(res.products.vel["v1"]).astype(np.float64)
    kx, ky, kz = _kvecs(N)
    inv = _inv_k2(kx, ky, kz)
    w = np.broadcast_to(
        np.where((np.arange(N // 2 + 1).reshape(1, 1, -1) > 0)
                 & (np.arange(N // 2 + 1).reshape(1, 1, -1) < N // 2),
                 2.0, 1.0), kden.shape)
    amp2 = np.abs(kden) ** 2 * w / float(N) ** 6
    for a, ka in enumerate((kx, ky, kz)):
        var_expect = (amp2 * ka * ka * inv * inv).sum()
        var_got = (v1[a] ** 2).mean()
        assert abs(var_got / var_expect - 1.0) < 0.005, a


def test_displacement_variance_vs_theory(oracle_run,
                                         hmf_validation_cosmology):
    """Per-axis Zel'dovich variance vs linear theory
    sigma_psi^2 = sum_k P(k) k_a^2/k^4 / V over the alive modes: within
    4x the estimator's own noise (the variance sum is dominated by a few
    low-k Exp(1) modes, so the floor is statistical, not a tolerance
    choice)."""
    p, res, kden = oracle_run
    cosmo = hmf_validation_cosmology
    N = p.GridSize
    Box = p.BoxSize_htrue
    cell = Box / N
    v1 = np.asarray(res.products.vel["v1"]).astype(np.float64)
    kx, ky, kz = _kvecs(N)
    inv = _inv_k2(kx, ky, kz)       # grid units
    alive = np.abs(kden) > 0
    kmag_phys = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2) / cell
    w = np.broadcast_to(
        np.where((np.arange(N // 2 + 1).reshape(1, 1, -1) > 0)
                 & (np.arange(N // 2 + 1).reshape(1, 1, -1) < N // 2),
                 2.0, 1.0), kden.shape)
    Pth = cosmo.PowerSpectrum(np.maximum(kmag_phys, 1e-12))
    wP = np.where(alive, Pth * w, 0.0)
    D1 = float(cosmo.GrowingMode(p.zlast, p.k_for_GM))
    for a, ka in enumerate((kx, ky, kz)):
        terms = wP * (ka * ka) * inv * inv / Box ** 3 * D1 ** 2
        var_expect = terms.sum()
        rel_sd = np.sqrt((terms ** 2).sum()) / var_expect
        var_got = (v1[a] ** 2).mean()
        assert abs(var_got / var_expect - 1.0) < max(4.0 * rel_sd, 0.05), \
            (a, var_got, var_expect, rel_sd)
