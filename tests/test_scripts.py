"""End-user scripts: FITS conversion round trip, CAMB-input generation
(the reference's SCALE_DEP_LCDM consistency scenario,
tests/pk_and_HMF_tests/SCALE_DEP_LCDM), PLC geometry parsing."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fits_roundtrip(tmp_path, reference_file):
    example_cat = reference_file(
        "example/pinocchio.0.0000.example.catalog.out")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "pinocchio2fits.py"),
         example_cat, "--outdir", str(tmp_path)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "VALID" in r.stdout and "INVALID" not in r.stdout
    assert (tmp_path / "pinocchio.0.0000.example.catalog.fits").exists()


def test_camb_inputs_scale_dep_lcdm(tmp_path, hmf_validation_params):
    """Spectra generated from the internal LCDM cosmology, read back
    through the READ_PK_TABLE + SCALE_DEPENDENT machinery, must reproduce
    the plain LCDM growth (reference SCALE_DEP_LCDM test)."""
    import dataclasses
    from pinocchio_jax.cosmology import Cosmology

    from pinocchio_jax.config import HMF_VALIDATION as paramfile
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_camb_inputs.py"),
         paramfile, "--outdir", str(tmp_path), "--nz", "60", "--norad"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "pk_cb_059.dat").exists()
    assert (tmp_path / "hubble.dat").exists()

    p0 = hmf_validation_params
    c0 = Cosmology(p0)
    p1 = dataclasses.replace(p0,
                             FileWithInputSpectrum="CAMBTable",
                             CAMBMatterFile=str(tmp_path / "pk_cb"),
                             CAMBRedshiftsFile=str(tmp_path /
                                                   "redshifts.dat"))
    p1.validate()
    assert p1.scale_dependent and p1.read_pk_table
    c1 = Cosmology(p1)

    zs = np.array([0.0, 0.5, 1.0, 2.0, 5.0])
    for k in (0.01, 1.0):
        g0 = np.asarray(c0.GrowingMode(zs)) / float(c0.GrowingMode(0.0))
        g1 = np.asarray(c1.GrowingMode(zs, k)) / float(c1.GrowingMode(0.0, k))
        np.testing.assert_allclose(g1, g0, rtol=5e-3)
    kk = np.logspace(-2, 0.5, 20)
    np.testing.assert_allclose(np.asarray(c1.PowerSpectrum(kk)),
                               np.asarray(c0.PowerSpectrum(kk)), rtol=1e-4)


def test_geometry_parse(tmp_path, hmf_validation_params):
    import dataclasses
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.plc import build_plc_geometry, write_geometry
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from plc_geometry_plot import parse_geometry

    p = dataclasses.replace(hmf_validation_params, plc_enabled=True,
                            StartingzForPLC=0.3, LastzForPLC=0.0,
                            PLCAperture=30.0)
    c = Cosmology(p)
    g = build_plc_geometry(p, c)
    path = write_geometry(p, g, 0.0, 100.0, str(tmp_path))
    meta, rows = parse_geometry(path)
    assert meta["nrepl"] == len(g.repls_ijk) == len(rows)
    assert meta["A"][0] == pytest.approx(30.0)
    assert len(meta["V"]) == 3 and len(meta["D"]) == 3
