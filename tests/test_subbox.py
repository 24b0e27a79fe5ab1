"""Multi-subbox fragmentation vs the single-box result.

Oracle: domain decomposition must be an implementation detail — halo
catalogs from N sub-boxes with boundary layers agree with the single-box
sweep except for boundary-layer truncation of the rarest largest halos
(DOCUMENTATION:127-133; the reference makes the same guarantee across MPI
task counts)."""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def single_and_multi(hmf_validation_params, hmf_validation_cosmology,
                     fmax_result):
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.fragment.subbox import (choose_nbox,
                                               run_fragmentation_multibox)
    from pinocchio_jax.io.catalogs import largest_halo_mass
    p, c = hmf_validation_params, hmf_validation_cosmology
    single = run_fragmentation(p, c, fmax_result, verbose=False)
    largest = largest_halo_mass(p, c)
    nbox = choose_nbox(p, c, largest, 4)
    multi = run_fragmentation_multibox(p, c, fmax_result, nbox,
                                       largest_mass=largest, verbose=False)
    return single, multi


def test_halo_counts_match(single_and_multi, hmf_validation_params):
    single, multi = single_and_multi
    mh = hmf_validation_params.MinHaloMass
    for s_snap, m_snap in zip(single.catalogs, multi.catalogs):
        ns = (s_snap.mass >= mh).sum()
        nm = (m_snap.mass >= mh).sum()
        assert abs(int(nm) - int(ns)) <= max(5, 0.005 * ns), \
            (s_snap.z, ns, nm)


def test_halo_identity_match(single_and_multi):
    """The vast majority of halos must be identical (same peak name,
    same mass)."""
    single, multi = single_and_multi
    s, m = single.catalogs[-1], multi.catalogs[-1]
    sm = dict(zip(s.name.tolist(), s.mass.tolist()))
    matched = sum(1 for nm, ms in zip(m.name.tolist(), m.mass.tolist())
                  if sm.get(nm) == ms)
    assert matched / len(s.name) > 0.97


def test_no_duplicate_halos(single_and_multi):
    _, multi = single_and_multi
    for snap in multi.catalogs:
        assert len(np.unique(snap.name)) == len(snap.name)


def test_mass_functions_match(single_and_multi):
    single, multi = single_and_multi
    s, m = single.catalogs[-1], multi.catalogs[-1]
    bins = np.arange(1, 5, 0.2)
    hs, _ = np.histogram(np.log10(s.mass), bins=bins)
    hm, _ = np.histogram(np.log10(m.mass), bins=bins)
    big = hs > 100
    assert np.abs(hm[big] / hs[big] - 1.0).max() < 0.03
