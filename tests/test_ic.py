"""IC generator: Hermitian symmetry, realized power, variance oracle."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def grid_and_field(hmf_validation_cosmology, hmf_validation_params):
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    p = hmf_validation_params
    g = Grid(N=64, BoxSize=p.BoxSize_htrue)
    kd = np.asarray(generate_kdensity(g, hmf_validation_cosmology,
                                      p.RandomSeed))
    return g, kd


def test_hermitian_symmetry_kz0(grid_and_field):
    g, kd = grid_and_field
    N = g.N
    plane = kd[:, :, 0]
    mirrored = plane[(N - np.arange(N)) % N][:, (N - np.arange(N)) % N]
    np.testing.assert_allclose(plane, np.conj(mirrored), atol=1e-6)


def test_real_field(grid_and_field):
    """The full inverse FFT of the Hermitian-extended cube must be real."""
    g, kd = grid_and_field
    N = g.N
    full = np.zeros((N, N, N), complex)
    full[:, :, :N // 2 + 1] = kd
    kz = np.arange(1, N // 2)
    full[:, :, N - kz] = np.conj(
        kd[(N - np.arange(N)) % N][:, (N - np.arange(N)) % N][:, :, kz])
    field = np.fft.ifftn(full)
    ratio = np.abs(field.imag).max() / np.abs(field.real).max()
    assert ratio < 1e-4


def test_nyquist_and_dc_empty(grid_and_field):
    g, kd = grid_and_field
    N = g.N
    assert kd[0, 0, 0] == 0
    assert np.all(kd[N // 2, :, :] == 0)
    assert np.all(kd[:, N // 2, :] == 0)
    assert np.all(kd[:, :, N // 2] == 0)


def test_realized_power_spectrum(grid_and_field, hmf_validation_cosmology):
    """Binned |delta_k|^2 * V / N^6 must track P(k) (GenIC contract)."""
    g, kd = grid_and_field
    from pinocchio_jax.grids import mode_radius_sq
    N = g.N
    V = g.BoxSize ** 3
    m2 = mode_radius_sq(N)
    kf = 2 * np.pi / g.BoxSize
    kmag = kf * np.sqrt(m2)
    pk_est = np.abs(kd) ** 2 * V / float(N) ** 6
    alive = pk_est > 0
    bins = kf * np.arange(1, N // 2, 2)
    for lo, hi in zip(bins[:-1], bins[1:]):
        sel = alive & (kmag >= lo) & (kmag < hi)
        if sel.sum() < 200:
            continue
        pk_th = hmf_validation_cosmology.PowerSpectrum(
            0.5 * (lo + hi))
        ratio = pk_est[sel].mean() / pk_th
        # Rayleigh amplitudes: relative error ~ 1/sqrt(Nmodes)
        assert abs(ratio - 1.0) < 5.0 / np.sqrt(sel.sum()) + 0.1, \
            f"power off at k={0.5 * (lo + hi):.3f}: ratio {ratio:.3f}"


def test_fixed_ic_amplitude(hmf_validation_cosmology, hmf_validation_params):
    """FixedIC: |delta| = sqrt(P) exactly (no Rayleigh scatter)."""
    from pinocchio_jax.grids import Grid, mode_radius_sq
    from pinocchio_jax.ic import generate_kdensity
    p = hmf_validation_params
    g = Grid(N=32, BoxSize=p.BoxSize_htrue)
    kd = np.asarray(generate_kdensity(g, hmf_validation_cosmology,
                                      p.RandomSeed, fixed=True))
    m2 = mode_radius_sq(32)
    kf = 2 * np.pi / g.BoxSize
    sel = (np.abs(kd) > 0) & (m2 == 9)   # one shell
    pk = hmf_validation_cosmology.PowerSpectrum(kf * 3.0)
    amp_expected = np.sqrt(pk / g.BoxSize ** 3) * 32 ** 3
    np.testing.assert_allclose(np.abs(kd[sel]), amp_expected, rtol=1e-3)


def test_paired_ic_opposite_phase(hmf_validation_cosmology,
                                  hmf_validation_params):
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    p = hmf_validation_params
    g = Grid(N=32, BoxSize=p.BoxSize_htrue)
    a = np.asarray(generate_kdensity(g, hmf_validation_cosmology, 1))
    b = np.asarray(generate_kdensity(g, hmf_validation_cosmology, 1,
                                     paired=True))
    np.testing.assert_allclose(b, -a, rtol=2e-5,
                               atol=1e-6 * np.abs(a).max())
