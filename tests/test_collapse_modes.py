"""ELL_SNG and TABULATED_CT collapse modes."""

import dataclasses

import numpy as np
import pytest


def test_sng_spherical_limit(hmf_validation_cosmology):
    """Spherical triaxial collapse must reproduce delta_c ~ 1.686: the SNG
    ODE's F for lambda_i = delta/3 should satisfy D(z_c) * delta ~ 1.686
    within a few percent (Nadkarni-Ghosh & Singhal 2016)."""
    from pinocchio_jax.ops.sng import ell_sng_F
    c = hmf_validation_cosmology
    # delta must exceed 1.686/D(a->inf): in this LCDM growth saturates
    # near ~1.3, so delta=1.2 correctly never collapses
    delta = np.array([1.686, 2.5, 4.0])
    lam = delta / 3.0
    D_in = float(c.GrowingMode(1.0 / 1.e-5 - 1.0))
    F = ell_sng_F(lam, lam, lam, D_in, c)
    assert (F > 0).all()
    F_sub = ell_sng_F(np.array([0.4]), np.array([0.4]), np.array([0.4]),
                      D_in, c)
    assert F_sub[0] == 0.0      # sub-critical: no collapse ever
    D_c = np.array([float(c.GrowingMode(f - 1.0)) for f in F])
    dc = D_c * delta
    np.testing.assert_allclose(dc, 1.686, rtol=0.06)


def test_sng_no_collapse_for_voids(hmf_validation_cosmology):
    from pinocchio_jax.ops.sng import ell_sng_F
    c = hmf_validation_cosmology
    D_in = float(c.GrowingMode(1.0 / 1.e-5 - 1.0))
    F = ell_sng_F(np.array([-0.5]), np.array([-0.6]), np.array([-0.7]),
                  D_in, c)
    assert F[0] == 0.0


def test_delta_sampling_properties():
    from pinocchio_jax.ops.tabulated import (CT_DELTA0, CT_NBINS_D,
                                             CT_RANGE_D, delta_sampling)
    dv = delta_sampling()
    assert len(dv) == CT_NBINS_D
    assert dv[0] == -CT_RANGE_D
    assert (np.diff(dv) > 0).all()
    # finest sampling near CT_DELTA0
    i0 = np.argmin(np.abs(dv - CT_DELTA0))
    assert np.diff(dv)[max(i0 - 1, 0)] < np.diff(dv)[0]
    assert np.diff(dv)[max(i0 - 1, 0)] < np.diff(dv)[-1]


def test_tabulated_matches_classic(hmf_validation_cosmology):
    """Interpolated table F vs direct classic F on random eigenvalues."""
    import jax.numpy as jnp
    from pinocchio_jax.ops import tabulated
    from pinocchio_jax.ops.collapse import ell_classic
    c = hmf_validation_cosmology
    ampl = 1.3
    flat = tabulated.build_ct_table(c, ampl, model="classic")
    tab = jnp.asarray(flat.reshape(tabulated.CT_NBINS_XY,
                                   tabulated.CT_NBINS_XY,
                                   tabulated.CT_NBINS_D).astype(np.float32))
    dv = jnp.asarray(tabulated.delta_sampling().astype(np.float32))
    aux = np.linspace(-tabulated.CT_RANGE_D, tabulated.CT_RANGE_D,
                      tabulated.AUX_N)
    idx_map = jnp.asarray(np.clip(
        np.searchsorted(tabulated.delta_sampling(), aux, "right") - 1,
        0, tabulated.CT_NBINS_D - 2).astype(np.int32))

    rng = np.random.default_rng(3)
    lam = np.sort(rng.normal(0, ampl / np.sqrt(3), (3000, 3)),
                  axis=1)[:, ::-1]
    l1, l2, l3 = (jnp.asarray(lam[:, i], jnp.float32) for i in range(3))
    F_tab = np.asarray(tabulated.interpolate_F(tab, dv, idx_map,
                                               jnp.float32(ampl),
                                               l1, l2, l3))
    bc = np.asarray(ell_classic(l1, l2, l3))
    F_dir = np.where(bc > 0,
                     1.0 + c.InverseGrowingMode(np.maximum(bc, 1e-30)),
                     0.0)
    # compare where clearly collapsing (interpolation smears the boundary)
    sel = (F_dir > 1.0) & (F_tab > 0)
    rel = np.abs(F_tab[sel] - F_dir[sel]) / F_dir[sel]
    assert np.median(rel) < 0.01
    assert (rel < 0.1).mean() > 0.95


def _small_ct(cosmo, ampl=1.3):
    import jax.numpy as jnp
    from pinocchio_jax.ops import tabulated
    flat = tabulated.build_ct_table(cosmo, ampl, model="classic")
    tab = flat.reshape(tabulated.CT_NBINS_XY, tabulated.CT_NBINS_XY,
                       tabulated.CT_NBINS_D).astype(np.float32)
    dv64 = tabulated.delta_sampling()
    tab2 = tabulated.spline_d2(tab, dv64)
    aux = np.linspace(-tabulated.CT_RANGE_D, tabulated.CT_RANGE_D,
                      tabulated.AUX_N)
    idx_map = np.clip(np.searchsorted(dv64, aux, "right") - 1,
                      0, tabulated.CT_NBINS_D - 2).astype(np.int32)
    return (jnp.asarray(tab), jnp.asarray(tab2),
            jnp.asarray(dv64.astype(np.float32)), jnp.asarray(idx_map),
            ampl)


def test_ct_interp_node_parity(hmf_validation_cosmology):
    """All three interpolation variants (collapse_times.c:1139-1231)
    reproduce the table values exactly at the table nodes — splines and
    the trilinear lookup all pass through the control points."""
    import jax.numpy as jnp
    from pinocchio_jax.ops import tabulated
    tab, tab2, dv, idx_map, ampl = _small_ct(hmf_validation_cosmology)
    rng = np.random.default_rng(11)
    ids = rng.integers(1, tabulated.CT_NBINS_D - 1, 200)
    ixs = rng.integers(0, tabulated.CT_NBINS_XY - 1, 200)
    iys = rng.integers(0, tabulated.CT_NBINS_XY - 1, 200)
    dvn = np.asarray(dv)
    d = dvn[ids]
    x = ixs * tabulated.BIN_X
    y = iys * tabulated.BIN_X
    l1 = jnp.asarray((d + 2 * x + y) / 3.0 * ampl, jnp.float32)
    l2 = jnp.asarray((d - x + y) / 3.0 * ampl, jnp.float32)
    l3 = jnp.asarray((d - x - 2 * y) / 3.0 * ampl, jnp.float32)
    want = np.asarray(tab)[iys, ixs, ids]
    for variant in ("trilinear", "bilinear", "bicubic"):
        got = np.asarray(tabulated.interp_F(variant, tab, tab2, dv,
                                            idx_map, jnp.float32(ampl),
                                            l1, l2, l3))
        assert np.allclose(got, want, atol=5e-4), variant


def test_ct_interp_variants_agree_off_node(hmf_validation_cosmology):
    """Off-node, the spline variants track trilinear at the interpolation-
    error level and are closer to the direct classic solution on average
    (the point of the higher-order options for coarse tables)."""
    import jax.numpy as jnp
    from pinocchio_jax.ops import tabulated
    from pinocchio_jax.ops.collapse import ell_classic
    c = hmf_validation_cosmology
    tab, tab2, dv, idx_map, ampl = _small_ct(c)
    rng = np.random.default_rng(5)
    lam = np.sort(rng.normal(0, ampl / np.sqrt(3), (4000, 3)),
                  axis=1)[:, ::-1]
    l1, l2, l3 = (jnp.asarray(lam[:, i], jnp.float32) for i in range(3))
    F = {v: np.asarray(tabulated.interp_F(v, tab, tab2, dv, idx_map,
                                          jnp.float32(ampl), l1, l2, l3))
         for v in ("trilinear", "bilinear", "bicubic")}
    bc = np.asarray(ell_classic(l1, l2, l3))
    F_dir = np.where(bc > 0,
                     1.0 + c.InverseGrowingMode(np.maximum(bc, 1e-30)),
                     0.0)
    sel = (F_dir > 1.05) & (F["trilinear"] > 1.0)
    for v in ("bilinear", "bicubic"):
        d = np.abs(F[v][sel] - F["trilinear"][sel])
        assert np.median(d) < 0.01, v
        err_v = np.abs(F[v][sel] - F_dir[sel]) / F_dir[sel]
        err_t = np.abs(F["trilinear"][sel] - F_dir[sel]) / F_dir[sel]
        assert np.median(err_v) <= np.median(err_t) * 1.05, v


def test_ct_interp_pipeline_bicubic(hmf_validation_params,
                                    hmf_validation_cosmology):
    """ct_interp='bicubic' through run_fmax tracks the trilinear run."""
    from pinocchio_jax.fmax import run_fmax
    p = dataclasses.replace(hmf_validation_params, GridSize=32,
                            ell_model="tabulated", ct_interp="bicubic")
    p_tri = dataclasses.replace(p, ct_interp="trilinear")
    c = hmf_validation_cosmology
    Fb = np.asarray(run_fmax(p, c, verbose=False).products.Fmax)
    Ft = np.asarray(run_fmax(p_tri, c, verbose=False).products.Fmax)
    both = (Fb > 0) & (Ft > 0)
    assert both.mean() > 0.95 * max((Fb > 0).mean(), (Ft > 0).mean())
    assert np.median(np.abs(Fb[both] - Ft[both])) < 0.01


def test_tabulated_pipeline(hmf_validation_params,
                            hmf_validation_cosmology):
    """64^3 fmax with ell_model='tabulated' tracks the classic run."""
    from pinocchio_jax.fmax import run_fmax
    p = dataclasses.replace(hmf_validation_params, GridSize=64,
                            ell_model="tabulated")
    p_classic = dataclasses.replace(p, ell_model="classic")
    c = hmf_validation_cosmology
    r_tab = run_fmax(p, c, verbose=False)
    r_cls = run_fmax(p_classic, c, verbose=False)
    Ft = np.asarray(r_tab.products.Fmax).ravel()
    Fc = np.asarray(r_cls.products.Fmax).ravel()
    # collapsed fractions agree within 2%
    f_t = (Ft >= 1.0).mean()
    f_c = (Fc >= 1.0).mean()
    assert abs(f_t - f_c) < 0.02 * max(f_c, 1e-9)
    # cell-wise: most collapsed cells agree well
    both = (Ft >= 1.0) & (Fc >= 1.0)
    rel = np.abs(Ft[both] - Fc[both]) / Fc[both]
    assert np.median(rel) < 0.02
