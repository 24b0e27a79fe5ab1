"""Byte-compatibility of the binary outputs with the reference's OWN
reader (scripts/ReadPinocchio5.py of the reference checkout).

Round 1 only round-tripped through this repo's readers; these tests prove
that a reference user's analysis stack parses this engine's catalog,
histories, and PLC files unchanged — including NumFiles>1 catalogs.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest


@pytest.fixture(scope="session")
def ref_reader(reference_file):
    spec = importlib.util.spec_from_file_location(
        "ReadPinocchio5", reference_file("scripts/ReadPinocchio5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def written_run(hmf_validation_params, hmf_validation_cosmology,
                tmp_path_factory):
    """A small binary-output run with PLC + histories, written to disk."""
    from pinocchio_jax.run import run_pipeline
    outdir = str(tmp_path_factory.mktemp("refcompat"))
    p = dataclasses.replace(hmf_validation_params, GridSize=64,
                            plc_enabled=True, StartingzForPLC=0.3,
                            LastzForPLC=0.0, CatalogInAscii=False)
    res = run_pipeline(p, outdir=outdir, verbose=False, write_outputs=True)
    return p, outdir, res


def test_catalog_read_by_reference_reader(written_run, ref_reader):
    p, outdir, res = written_run
    path = os.path.join(outdir, f"pinocchio.0.0000.{p.RunFlag}.catalog.out")
    cat = ref_reader.catalog(path, silent=True)
    snap = res["frag"].catalogs[-1]
    assert cat.Nhalos == len(snap.mass)
    np.testing.assert_array_equal(np.asarray(cat.data["name"], np.uint64),
                                  snap.name)
    np.testing.assert_array_equal(cat.Npart, snap.mass)
    from pinocchio_jax.io.catalogs import convert_catalog_units
    M, q, x, v = convert_catalog_units(p, snap)
    np.testing.assert_allclose(cat.Mass, M, rtol=1e-6)
    np.testing.assert_allclose(cat.pos, x, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cat.data['posin'], q, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(cat.vel, v, rtol=1e-5, atol=1e-4)


def test_multifile_catalog_read_by_reference_reader(
        written_run, ref_reader, hmf_validation_cosmology, tmp_path):
    """NumFiles=3 chunked catalogs (collector scheme,
    write_halos.c:194-225) must be recognized and concatenated by the
    reference reader."""
    from pinocchio_jax.io.catalogs import write_catalog
    p, outdir, res = written_run
    snap = res["frag"].catalogs[-1]
    p3 = dataclasses.replace(p, NumFiles=3)
    write_catalog(p3, snap, str(tmp_path))
    base = os.path.join(str(tmp_path),
                        f"pinocchio.0.0000.{p.RunFlag}.catalog.out")
    assert os.path.exists(base + ".0") and os.path.exists(base + ".2")
    cat = ref_reader.catalog(base, silent=True)
    assert cat.Nfiles == 3
    assert cat.Nhalos == len(snap.mass)
    np.testing.assert_array_equal(np.asarray(cat.data["name"], np.uint64),
                                  snap.name)
    np.testing.assert_array_equal(cat.Npart, snap.mass)


def test_histories_read_by_reference_reader(written_run, ref_reader):
    p, outdir, res = written_run
    path = os.path.join(outdir, f"pinocchio.{p.RunFlag}.histories.out")
    hist = ref_reader.histories(path, silent=True)
    from pinocchio_jax.io.catalogs import build_histories_flat
    treelen, rec = build_histories_flat(res["frag"].groups, p.MinHaloMass)
    assert hist.Ntrees == len(treelen)
    assert hist.Nbranches_tot == len(rec)
    np.testing.assert_array_equal(hist.Nbranches, treelen)
    np.testing.assert_array_equal(
        np.asarray(hist.data["name"], np.uint64), rec["name"])
    np.testing.assert_array_equal(hist.data["nickname"], rec["nick"])
    np.testing.assert_array_equal(hist.data["merged_with"], rec["mw"])
    np.testing.assert_allclose(hist.data["z_appear"], rec["zap"])


def test_plc_read_by_reference_reader(written_run, ref_reader):
    p, outdir, res = written_run
    path = os.path.join(outdir, f"pinocchio.{p.RunFlag}.plc.out")
    plc = ref_reader.plc(path, silent=True)
    mine = res["frag"].plc
    assert plc.Nhalos == len(mine.z)
    np.testing.assert_array_equal(np.asarray(plc.data["name"], np.uint64),
                                  mine.name)
    np.testing.assert_allclose(plc.data["truez"], mine.z, rtol=1e-6)
    hfac = p.Hubble100 if p.OutputInH100 else 1.0
    np.testing.assert_allclose(
        plc.data["Mass"],
        (mine.mass * (p.ParticleMass * hfac)).astype(np.float32),
        rtol=1e-6)
    # angles within bounds
    assert (plc.data["theta"] >= -90.0).all()
    assert (plc.data["theta"] <= 90.0).all()
    assert (plc.data["phi"] >= 0.0).all() and (plc.data["phi"] < 360.0).all()


def test_own_readers_agree_with_reference_reader(written_run, ref_reader):
    """The in-repo readers and the reference reader must parse the same
    bytes identically (io/readers.py vs ReadPinocchio5 dtypes)."""
    from pinocchio_jax.io import readers
    p, outdir, res = written_run
    path = os.path.join(outdir, f"pinocchio.0.0000.{p.RunFlag}.catalog.out")
    ours = readers.read_catalog(path)
    ref = ref_reader.catalog(path, silent=True)
    np.testing.assert_array_equal(np.asarray(ours["name"], np.uint64),
                                  np.asarray(ref.data["name"], np.uint64))
    np.testing.assert_allclose(ours["M"], ref.Mass)


def test_light_output_read_by_reference_reader(written_run, ref_reader,
                                               tmp_path):
    """-DLIGHT_OUTPUT analog: the 48-byte record is auto-detected by
    ReadPinocchio5 (its record_length==48 branch) and by io.readers."""
    from pinocchio_jax.io.catalogs import (CATALOG_LIGHT_DTYPE,
                                           convert_catalog_units,
                                           write_catalog)
    from pinocchio_jax.io.readers import read_catalog
    p, outdir, res = written_run
    p_light = dataclasses.replace(p, light_output=True)
    snap = res["frag"].catalogs[-1]
    path = write_catalog(p_light, snap, str(tmp_path))
    assert CATALOG_LIGHT_DTYPE.itemsize == 48

    cat = ref_reader.catalog(path, silent=True)
    assert cat.Nhalos == len(snap.mass)
    np.testing.assert_array_equal(np.asarray(cat.data["name"], np.uint64),
                                  snap.name)
    M, q, x, v = convert_catalog_units(p_light, snap)
    np.testing.assert_allclose(cat.Mass, M, rtol=1e-6)
    np.testing.assert_allclose(cat.pos, x, rtol=1e-6)

    mine = read_catalog(path)
    np.testing.assert_array_equal(mine["name"], snap.name)
    np.testing.assert_allclose(mine["x"], x, rtol=1e-6)
    assert (mine["n"] == 0).all()        # light format drops npart
