"""Memory planner + runtime budget enforcement
(allocations.c:37-251,317-324; run_planner.c:44-140; fragment.c:258-283,
964-1065 analogs)."""

import dataclasses

import numpy as np
import pytest


def test_collapsed_fraction_calibration(hmf_validation_params,
                                        hmf_validation_cosmology,
                                        fmax_result):
    """The planner's collapsed-fraction forecast must bound the measured
    fraction from above within ~10% (it drives the host memory budget)."""
    from pinocchio_jax.planner import collapsed_fraction
    frac = collapsed_fraction(hmf_validation_params,
                              hmf_validation_cosmology)
    F = np.asarray(fmax_result.products.Fmax)
    measured = float((F >= hmf_validation_params.Flast).mean())
    assert measured <= frac <= 1.10 * measured, (frac, measured)


def test_plan_1024_prints_map(hmf_validation_params,
                              hmf_validation_cosmology, capsys):
    """A 1024^3 plan must produce the full per-array map without
    allocating anything."""
    from pinocchio_jax import planner
    p = dataclasses.replace(hmf_validation_params, GridSize=1024)
    r = planner.plan(p, n_chips=8, verbose=True,
                     cosmo=hmf_validation_cosmology)
    out = capsys.readouterr().out
    assert "RUN PLAN for 1024^3" in out
    assert "hessian" in out or "kvectors" in out
    assert r["device_bytes"] > 0 and r["host_fragmentation_bytes"] > 0
    # 1024^3 staged: the displacement phase dominates
    assert r["device_peak_phase"] == "LPT displacements"


def test_budget_abort_preflight(hmf_validation_params,
                                hmf_validation_cosmology):
    """A too-small MaxMem budget must abort BEFORE any FFT/allocation,
    with the memory map in the message (allocations.c:317-324)."""
    from pinocchio_jax.planner import MemoryPlanError
    from pinocchio_jax.run import run_pipeline
    p = dataclasses.replace(hmf_validation_params, GridSize=512, MaxMem=64)
    with pytest.raises(MemoryPlanError) as ei:
        run_pipeline(p, verbose=False, write_outputs=False)
    assert "MaxMem" in str(ei.value)
    assert "RUN PLAN for 512^3" in str(ei.value)


def test_budget_bytes_per_particle(hmf_validation_params,
                                   hmf_validation_cosmology):
    from pinocchio_jax.planner import MemoryPlanError, enforce_budget
    p = dataclasses.replace(hmf_validation_params, MaxMemPerParticle=5.0)
    with pytest.raises(MemoryPlanError) as ei:
        enforce_budget(p, cosmo=hmf_validation_cosmology, verbose=False)
    assert "MaxMemPerParticle" in str(ei.value)


def test_budget_passes_for_valid_run(hmf_validation_params,
                                     hmf_validation_cosmology):
    """The shipped HMF_Validation config (MaxMem 3600, 150 B/particle)
    must clear the pre-flight."""
    from pinocchio_jax.planner import enforce_budget
    r = enforce_budget(hmf_validation_params,
                       cosmo=hmf_validation_cosmology, verbose=False)
    assert r["fits_host"]


def test_exit_if_extra_particles(hmf_validation_params,
                                 hmf_validation_cosmology, fmax_result):
    """ExitIfExtraParticles semantics (fragment.c:258-283): an
    undersized MaxMemPerParticle warns by default and aborts when the
    flag is set."""
    from pinocchio_jax.fragment.driver import run_fragmentation
    p = dataclasses.replace(hmf_validation_params, MaxMemPerParticle=20.0,
                            ExitIfExtraParticles=True)
    with pytest.raises(MemoryError) as ei:
        run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                          verbose=False)
    assert "MaxMemPerParticle" in str(ei.value)
    # without the flag: warn and continue
    p2 = dataclasses.replace(p, ExitIfExtraParticles=False)
    res = run_fragmentation(p2, hmf_validation_cosmology, fmax_result,
                            verbose=False)
    assert res.nstored > 0
    assert 0.0 < res.best_pred_peak_factor < 1.0


def test_chip_sweep(hmf_validation_params, hmf_validation_cosmology):
    from pinocchio_jax import planner
    p = dataclasses.replace(hmf_validation_params, GridSize=512)
    rows = planner.sweep(p, hbm_gb=16.0, max_chips=8, verbose=False)
    assert [r["chips"] for r in rows] == [1, 2, 4, 8]
    # device memory per chip must fall with the chip count
    assert rows[-1]["device_gb"] < rows[0]["device_gb"]


def test_estimate_file_sizes(hmf_validation_params,
                             hmf_validation_cosmology, capsys,
                             reference_file):
    """Output-size forecaster (estimate_file_size, fragment.c:964-1065):
    an order-of-magnitude tool (it integrates the analytic fit, which
    under-counts Pinocchio's low-mass halos ~2x, exactly as the
    reference's own estimator does) — demand the right decade."""
    import os
    from pinocchio_jax.planner import estimate_file_sizes
    est = estimate_file_sizes(hmf_validation_params,
                              hmf_validation_cosmology, verbose=True)
    out = capsys.readouterr().out
    assert "ESTIMATED STORAGE" in out
    shipped = os.path.getsize(reference_file(
        "HMF_Validation/pinocchio.0.0000.test.catalog.out"))
    assert 0.2 < est["catalogs"][0.0] / shipped < 3.0
