"""Scale-dependent growth (CAMB tables + Hubble table) vs the example
run's shipped oracles: pinocchio.example.cosmology.out and
pinocchio.example.scaledep.out."""

import numpy as np
import pytest

@pytest.fixture(scope="module")
def example_dir(reference_file):
    """The reference's shipped example run (inputs and outputs)."""
    import os
    return os.path.dirname(reference_file("example/parameter_file"))


@pytest.fixture(scope="module")
def example_cosmo(example_dir):
    from pinocchio_jax.config import read_parameter_file
    from pinocchio_jax.cosmology import Cosmology
    p = read_parameter_file(example_dir + "/parameter_file")
    return p, Cosmology(p)


def test_feature_flags(example_cosmo):
    p, c = example_cosmo
    assert p.scale_dependent and p.read_pk_table
    assert p.recompute_displacements
    assert c.scale_dep
    assert c._hubble_spline is not None


def test_cosmology_table_vs_oracle(example_cosmo, example_dir, tmp_path):
    p, c = example_cosmo
    path = c.write_cosmology_file(str(tmp_path))
    mine = np.loadtxt(path)
    ref = np.loadtxt(example_dir + "/pinocchio.example.cosmology.out")
    rel = np.abs(mine - ref) / (np.abs(ref) + 1e-30)
    # exact columns: scale factor, distances, Om, variances, P(k)
    for col in (0, 2, 3, 4, 14, 15, 16, 18, 19):
        assert rel[:, col].max() < 2e-3, col
    # growth columns: median must be at interpolation precision (the max
    # differs near the first CAMB redshift where both codes' 2D splines
    # produce edge artifacts)
    for col in (6, 7, 8, 9):
        assert np.median(rel[:, col]) < 1e-4, col
        assert rel[:, col].max() < 0.1, col


def test_scaledep_table_vs_oracle(example_cosmo, example_dir):
    p, c = example_cosmo
    ref = np.loadtxt(example_dir + "/pinocchio.example.scaledep.out")
    a = ref[:, 0]
    z = 1.0 / a - 1.0
    ks = 10.0 ** (-3.0 + 0.5 * np.arange(10))
    # D1 at first and last k bin (columns 2 and 11 -> idx 1, 10)
    for j, col in ((0, 1), (9, 10)):
        mine = np.array([float(c.GrowingMode(zz, ks[j])) for zz in z])
        rel = np.abs(mine - ref[:, col]) / np.abs(ref[:, col])
        assert np.median(rel) < 1e-4
    # growth is genuinely scale-dependent: D(k_hi)/D(k_lo) != 1 at z=1
    r = float(c.GrowingMode(1.0, ks[9]) / c.GrowingMode(1.0, ks[0]))
    assert abs(r - 1.0) > 1e-4


def test_hubble_table_used(example_cosmo):
    p, c = example_cosmo
    # E(z=0) ~ 1 from the table; high-z slope reflects radiation
    e0 = float(np.sqrt(c.Esq(0.0)))
    assert abs(e0 - 1.0) < 0.02
    e_ratio = float(np.sqrt(c.Esq(9.0) / c.Esq(4.0)))
    lcdm = np.sqrt((p.Omega0 * 10 ** 3 + p.OmegaLambda)
                   / (p.Omega0 * 5 ** 3 + p.OmegaLambda))
    assert abs(e_ratio / lcdm - 1.0) < 0.05


def test_segment_weight_tables(hmf_validation_params,
                               hmf_validation_cosmology):
    """w=1 at each segment's own redshift; w=0 at the previous one."""
    from pinocchio_jax.fragment.driver import _segment_weight_tables
    p, c = hmf_validation_params, hmf_validation_cosmology
    tabs = _segment_weight_tables(p, c, None, n=4096)
    zs = p.output_z
    logF = np.linspace(np.log10(p.Flast) - 1e-4, np.log10(1500.0), 4096)
    F = 10.0 ** logF
    for s in range(len(zs)):
        w = tabs["w1"][s]
        iF = np.argmin(np.abs(F - (1.0 + zs[s])))
        assert abs(w[iF] - 1.0) < 5e-3   # table-grid quantization
        if s > 0:
            iprev = np.argmin(np.abs(F - (1.0 + zs[s - 1])))
            assert abs(w[iprev]) < 5e-3


def test_fr_modified_gravity_growth():
    """f(R) gravity: growth enhanced below the Compton scale, GR recovered
    at k -> 0 (mu -> 1, cosmo.c:598-606)."""
    from pinocchio_jax.config import Params
    from pinocchio_jax.cosmology import Cosmology
    p = Params(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
               output_z=[0.0])
    c = Cosmology(p)
    assert c.scale_dep
    # k=0 bin is GR: matches the scale-independent ODE result
    p0 = Params(output_z=[0.0])
    c0 = Cosmology(p0)
    for z in (0.0, 1.0, 3.0):
        np.testing.assert_allclose(float(c.GrowingMode(z, 1e-4)),
                                   float(c0.GrowingMode(z)), rtol=2e-3)
    # enhancement grows monotonically with k at fixed z
    ks = [0.001, 0.03, 0.3, 3.0]
    vals = [float(c.GrowingMode(0.5, k) / c0.GrowingMode(0.5)) for k in ks]
    assert all(b >= a - 1e-12 for a, b in zip(vals, vals[1:]))
    assert vals[-1] > 1.05
    # weaker fr0 -> weaker enhancement
    c2 = Cosmology(Params(mod_grav_fr=True, fr0=1e-7,
                          scale_dependent=True, output_z=[0.0]))
    assert (float(c2.GrowingMode(0.5, 3.0) / c2.GrowingMode(0.5, 1e-4))
            < float(c.GrowingMode(0.5, 3.0) / c.GrowingMode(0.5, 1e-4)))
