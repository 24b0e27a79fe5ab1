"""Past-light-cone geometry + on-the-fly crossing detection.

Oracles: geometric invariants of the replication machinery, and the
consistency of the produced n(z) with the analytic halo-count prediction
(the reference validates its PLC the same way: write_halos.c nz.out col 5).
"""

import numpy as np
import pytest


def test_cone_cube_intersect_basic():
    from pinocchio_jax.plc import cone_and_cube_intersect
    L = np.array([10.0, 10.0, 10.0])
    V = np.array([5.0, 5.0, 5.0])
    D = np.array([0.0, 0.0, 1.0])
    # vertex inside the cube
    code, rmin, rmax, axis = cone_and_cube_intersect(
        np.zeros(3), L, V, D, 30.0)
    assert code == 1 and rmin == 0.0
    # cube straight ahead along the axis
    code, rmin, rmax, axis = cone_and_cube_intersect(
        np.array([0.0, 0.0, 20.0]), L, V, D, 30.0)
    assert code >= 1
    assert 14.9 < rmin < 15.1
    # cube far to the side, narrow cone -> no intersection
    code, rmin, rmax, axis = cone_and_cube_intersect(
        np.array([200.0, 0.0, 0.0]), L, V, D, 10.0)
    assert code == 0
    # full sky always intersects
    code, _, _, _ = cone_and_cube_intersect(
        np.array([200.0, 0.0, 0.0]), L, V, D, 180.0)
    assert code >= 1


@pytest.fixture(scope="session")
def plc_run(hmf_validation_params, hmf_validation_cosmology, fmax_result):
    import dataclasses
    from pinocchio_jax.plc import build_plc_geometry
    from pinocchio_jax.fragment.driver import run_fragmentation
    p = dataclasses.replace(hmf_validation_params, plc_enabled=True)
    geom = build_plc_geometry(p, hmf_validation_cosmology, verbose=False)
    res = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                            plc_geom=geom, verbose=False)
    return p, geom, res


def test_replication_list(plc_run):
    p, geom, res = plc_run
    # every replication's F window is ordered: F1 (far, early) >= F2
    assert (geom.repls_F1 >= geom.repls_F2).all()
    # the (0,0,0) replication must be present (the cone vertex is inside)
    assert any((geom.repls_ijk == 0).all(axis=1))


def test_plc_halo_properties(plc_run):
    p, geom, res = plc_run
    plc = res.plc
    assert plc is not None and len(plc.z) > 1000
    assert not plc.overflow
    # redshifts within the requested range (brent_err tolerance)
    assert plc.z.min() >= min(p.LastzForPLC, p.StartingzForPLC) - 0.02
    assert plc.z.max() <= max(p.LastzForPLC, p.StartingzForPLC) + 0.02
    # all halos above the mass cut
    assert plc.mass.min() >= p.MinHaloMass
    # aperture respected: angle from the cone axis < PLCAperture
    rho = np.linalg.norm(plc.x, axis=1)
    cosang = plc.x @ geom.zvers / rho
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    assert ang.max() < p.PLCAperture + 1e-3
    # distance consistent with redshift: |r - r(z)| small
    from pinocchio_jax.cosmology import Cosmology
    pass


def test_plc_distance_redshift_consistency(plc_run,
                                           hmf_validation_cosmology):
    p, geom, res = plc_run
    plc = res.plc
    r_expected = hmf_validation_cosmology.ComovingDistance(plc.z)
    r_actual = np.linalg.norm(plc.x, axis=1)
    # crossing solved to brent_err ~ 0.01 IPD = 0.014 Mpc; allow slack for
    # the fp32 storage of positions
    frac_ok = (np.abs(r_actual - r_expected) < 0.5).mean()
    assert frac_ok > 0.99


def test_nz_vs_analytic_prediction(plc_run, hmf_validation_cosmology):
    from pinocchio_jax.plc import compute_nhalos_prediction
    p, geom, res = plc_run
    nz = res.plc.nz
    z_last = min(p.LastzForPLC, p.StartingzForPLC)
    # middle bins (away from edges) within 25% of the analytic count
    for ibin in range(1, geom.nzbins - 1):
        zlow = z_last + ibin * geom.delta_z
        zhigh = z_last + (ibin + 1) * geom.delta_z
        pred = compute_nhalos_prediction(p, hmf_validation_cosmology,
                                         zlow, zhigh)
        assert abs(nz[ibin] / pred - 1.0) < 0.25, (ibin, nz[ibin], pred)
