"""Fragmentation + outputs vs the reference's shipped HMF_Validation run.

Statistical oracles (different realization, same box/P(k)/decision rules):
event counters within ~2%, halo counts per output within ~3%, HMF bins with
good statistics within ~15%, histories tree/branch counts within ~2%.
Reference numbers from HMF_Validation/log_RUN.txt and the shipped catalogs.
"""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def frag_result(hmf_validation_params, hmf_validation_cosmology,
                fmax_result):
    from pinocchio_jax.fragment.driver import run_fragmentation
    return run_fragmentation(hmf_validation_params,
                             hmf_validation_cosmology, fmax_result,
                             verbose=False)


# reference log_RUN.txt tail
REF = dict(peaks=114993, good_halos=75499, accretions=615432,
           mergers=39494, filaments=499961, in_halos=730425)
REF_NHALOS = {2.0: 5248, 1.0: 8038, 0.5: 8709, 0.0: 8707}


def test_event_counters(frag_result):
    c = frag_result.counters
    assert abs(int(c[0]) / REF["peaks"] - 1) < 0.02
    assert abs(int(c[14]) / REF["good_halos"] - 1) < 0.02
    assert abs(int(c[7]) / REF["accretions"] - 1) < 0.03
    assert abs(int(c[10]) / REF["mergers"] - 1) < 0.03
    assert abs(int(c[12]) / REF["filaments"] - 1) < 0.02


def test_halo_counts_per_output(frag_result, hmf_validation_params):
    mh = hmf_validation_params.MinHaloMass
    for snap in frag_result.catalogs:
        ngood = int((snap.mass >= mh).sum())
        ref = REF_NHALOS[snap.z]
        assert abs(ngood / ref - 1) < 0.03, (snap.z, ngood, ref)


def test_mass_conservation(frag_result):
    """particles in halos + filaments = stored particles"""
    g = frag_result.groups
    in_halos = int(g.mass[2:][g.alive[2:] > 0].sum())
    filaments = int(g.mass[1])
    assert in_halos + filaments == frag_result.nstored
    assert abs(in_halos / REF["in_halos"] - 1) < 0.03


def test_mf_vs_reference(frag_result, hmf_validation_params,
                         hmf_validation_cosmology, tmp_path,
                         reference_file):
    from pinocchio_jax.io import catalogs as io_cat
    p = hmf_validation_params
    snap = [s for s in frag_result.catalogs if s.z == 0.0][0]
    path = io_cat.compute_mf(p, hmf_validation_cosmology, snap,
                             str(tmp_path))
    mine = np.loadtxt(path)
    ref = np.loadtxt(reference_file(
        "HMF_Validation/pinocchio.0.0000.test.mf.out"))
    n = min(len(mine), len(ref))
    cm, cr = mine[:n, 4], ref[:n, 4]
    good = (cm > 200) & (cr > 200)
    assert good.sum() >= 5
    rel = cm[good] / cr[good] - 1.0
    assert np.abs(rel).max() < 0.15
    # total number of halos within 3%
    assert abs(cm.sum() / cr.sum() - 1.0) < 0.03


def test_histories_structure(frag_result, hmf_validation_params, tmp_path):
    from pinocchio_jax.io.catalogs import build_histories
    trees = build_histories(frag_result.groups,
                            hmf_validation_params.MinHaloMass)
    ntrees = len(trees)
    nbranch = sum(len(t) for t in trees)
    # reference: 8707 trees, 14776 branches
    assert abs(ntrees / 8707 - 1) < 0.02
    assert abs(nbranch / 14776 - 1) < 0.02
    # structural invariants per tree
    for rec in trees[:200]:
        nb = len(rec)
        assert rec[0]["nick"] == nb           # main halo nick = Nbranches
        assert (rec["ll"] == np.arange(1, nb + 1)).all()
        # merged-with nicknames are within the tree
        mw = rec["mw"]
        assert ((mw == -1) | ((mw >= 1) & (mw <= nb))).all()
        # main halo never merged
        assert rec[0]["zme"] == -1.0


def test_catalog_roundtrip_binary(frag_result, hmf_validation_params,
                                  tmp_path):
    """Binary catalog must be parseable via the fortran-record layout that
    ReadPinocchio5.py expects."""
    from pinocchio_jax.io import catalogs as io_cat
    p = hmf_validation_params
    snap = frag_result.catalogs[0]
    import dataclasses
    p2 = dataclasses.replace(p) if dataclasses.is_dataclass(p) else p
    old = p.CatalogInAscii
    p.CatalogInAscii = False
    try:
        path = io_cat.write_catalog(p, snap, str(tmp_path))
    finally:
        p.CatalogInAscii = old
    with open(path, "rb") as fd:
        m1 = np.fromfile(fd, "<i4", 1)[0]
        hdr = np.fromfile(fd, "<i4", 2)
        m2 = np.fromfile(fd, "<i4", 1)[0]
        assert m1 == m2 == 8
        assert hdr[1] == io_cat.CATALOG_DTYPE.itemsize
        m1 = np.fromfile(fd, "<i4", 1)[0]
        ngood = np.fromfile(fd, "<i4", 1)[0]
        np.fromfile(fd, "<i4", 1)
        m1 = np.fromfile(fd, "<i4", 1)[0]
        rec = np.fromfile(fd, io_cat.CATALOG_DTYPE, ngood)
        m2 = np.fromfile(fd, "<i4", 1)[0]
        assert m1 == m2 == ngood * io_cat.CATALOG_DTYPE.itemsize
    assert (rec["n"] == snap.mass).all()
    assert (rec["name"] == snap.name).all()


def test_sparse_transfer_identical(hmf_validation_params,
                                   hmf_validation_cosmology, fmax_result):
    """Device-side needed-particle compaction (fetch_products_host) must
    reproduce the dense-transfer fragmentation bit-for-bit: the zeroed
    unselected cells are never read by the sweep."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host
    from pinocchio_jax.fragment.driver import run_fragmentation

    p_dense = dataclasses.replace(hmf_validation_params,
                                  sparse_transfer=False,
                                  transfer_f16=False)
    p_sparse = dataclasses.replace(hmf_validation_params,
                                   sparse_transfer=True,
                                   transfer_f16=False)
    # explicit sparse fetch: needed fraction is plausible, the compact
    # arrays carry exactly the selected cells' values in (-F, cell) order
    sp = fetch_products_host(p_sparse, fmax_result).host_products
    F0 = np.asarray(fmax_result.products.Fmax)
    sel = np.flatnonzero(F0.ravel() >= p_sparse.Flast)
    assert 0.05 < len(sel) / F0.size < 0.9
    assert sp.sorted_by == "F"
    assert (np.diff(sp.F) <= 0).all()
    o = np.argsort(sp.ci)
    assert np.array_equal(sp.ci[o], sel)
    assert np.array_equal(sp.F[o], F0.ravel()[sel])
    for k, v in fmax_result.products.vel.items():
        v0 = np.asarray(v).reshape(3, -1)
        assert np.array_equal(sp.vel[k][o], v0[:, sel].T)

    r0 = run_fragmentation(p_dense, hmf_validation_cosmology, fmax_result,
                           verbose=False)
    r1 = run_fragmentation(p_sparse, hmf_validation_cosmology, fmax_result,
                           verbose=False)
    assert np.array_equal(r0.counters, r1.counters)
    for c0, c1 in zip(r0.catalogs, r1.catalogs):
        assert np.array_equal(c0.name, c1.name)
        assert np.array_equal(c0.mass, c1.mass)
        assert np.array_equal(c0.x, c1.x)
        assert np.array_equal(c0.v, c1.v)


def test_overlapped_pending_fetch(hmf_validation_params,
                                  hmf_validation_cosmology, fmax_result):
    """run_fmax with sparse_transfer=True dispatches the needed-particle
    compaction DURING the LPT stage (fmax.PendingFetch); the resolved
    SparseProducts must equal the post-hoc compaction of the same field
    and drive an identical fragmentation."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host, run_fmax
    from pinocchio_jax.fragment.driver import run_fragmentation

    p = dataclasses.replace(hmf_validation_params, sparse_transfer=True,
                            transfer_f16=False)
    res = run_fmax(p, hmf_validation_cosmology, verbose=False)
    pf = res.pending_fetch
    assert pf is not None
    res = fetch_products_host(p, res)
    assert res.pending_fetch is None
    sp = res.host_products
    F0 = np.asarray(res.products.Fmax)
    sel = np.flatnonzero(F0.ravel() >= p.Flast)
    assert sp.sorted_by == "F"
    assert (np.diff(sp.F) <= 0).all()
    o = np.argsort(sp.ci)
    assert np.array_equal(sp.ci[o], sel)
    assert np.array_equal(sp.F[o], F0.ravel()[sel])
    for k, v in res.products.vel.items():
        v0 = np.asarray(v).reshape(3, -1)
        assert np.array_equal(sp.vel[k][o], v0[:, sel].T)
    # the transfer log counts every copied byte: idx + F, then the rows
    log = pf.log.summary()
    nkeys = len(res.products.vel)
    assert log["bytes"] == pf.cap * (4 + 4) + nkeys * pf.cap * 3 * 4
    assert log["busy_s"] > 0.0 and log["window_s"] > 0.0

    # catalogs identical to the dense path over the SAME product arrays
    p_dense = dataclasses.replace(hmf_validation_params,
                                  sparse_transfer=False,
                                  transfer_f16=False)
    res_dense = dataclasses.replace(res, host_products=None)
    r0 = run_fragmentation(p_dense, hmf_validation_cosmology, res_dense,
                           verbose=False)
    r1 = run_fragmentation(p, hmf_validation_cosmology, res, verbose=False)
    assert np.array_equal(r0.counters, r1.counters)
    for c0, c1 in zip(r0.catalogs, r1.catalogs):
        assert np.array_equal(c0.name, c1.name)
        assert np.array_equal(c0.mass, c1.mass)


def test_sparse_transfer_multibox(hmf_validation_params,
                                  hmf_validation_cosmology, fmax_result):
    """Sparse host products + sub-box membership (coordinate wrap) gives
    the same catalogs as the dense sub-domain extraction."""
    import dataclasses
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox

    p_dense = dataclasses.replace(hmf_validation_params,
                                  sparse_transfer=False,
                                  transfer_f16=False, subbox_tasks=4)
    p_sparse = dataclasses.replace(hmf_validation_params,
                                   sparse_transfer=True,
                                   transfer_f16=False, subbox_tasks=4)
    nbox = (2, 2, 1)
    r0 = run_fragmentation_multibox(p_dense, hmf_validation_cosmology,
                                    fmax_result, nbox, verbose=False)
    r1 = run_fragmentation_multibox(p_sparse, hmf_validation_cosmology,
                                    fmax_result, nbox, verbose=False)
    assert np.array_equal(r0.counters, r1.counters)
    for c0, c1 in zip(r0.catalogs, r1.catalogs):
        o0 = np.argsort(c0.name)
        o1 = np.argsort(c1.name)
        assert np.array_equal(c0.name[o0], c1.name[o1])
        assert np.array_equal(c0.mass[o0], c1.mass[o1])
        assert np.array_equal(c0.x[o0], c1.x[o1])


def test_sparse_recompute_segments(hmf_validation_params,
                                   hmf_validation_cosmology):
    """RECOMPUTE_DISPLACEMENTS through the sparse overlapped fetch: the
    per-segment stacks cross as needed rows (seg_sparse) and the sweep's
    segment reconstruction matches the dense-segment run exactly."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host, run_fmax
    from pinocchio_jax.fragment.driver import run_fragmentation

    base = dataclasses.replace(hmf_validation_params, GridSize=64,
                               recompute_displacements=True,
                               transfer_f16=False)
    assert len(base.output_z) > 1
    p_dense = dataclasses.replace(base, sparse_transfer=False)
    p_sparse = dataclasses.replace(base, sparse_transfer=True)
    c = hmf_validation_cosmology

    r_dense = run_fmax(p_dense, c, verbose=False)
    r_sparse = run_fmax(p_sparse, c, verbose=False)
    r_sparse = fetch_products_host(p_sparse, r_sparse)
    assert r_sparse.seg_sparse
    assert len(r_sparse.vel_segments) == len(base.output_z)

    f_dense = run_fragmentation(p_dense, c, r_dense, verbose=False)
    f_sparse = run_fragmentation(p_sparse, c, r_sparse, verbose=False)
    assert np.array_equal(f_dense.counters, f_sparse.counters)
    for c0, c1 in zip(f_dense.catalogs, f_sparse.catalogs):
        assert np.array_equal(c0.name, c1.name)
        assert np.array_equal(c0.mass, c1.mass)
        np.testing.assert_allclose(c0.x, c1.x, rtol=0, atol=2e-4)
        np.testing.assert_allclose(c0.v, c1.v, rtol=0, atol=2e-3)


def test_sparse_recompute_segments_subbox(hmf_validation_params,
                                          hmf_validation_cosmology):
    """Regression: the segment-crossing group-velocity rebuild must apply
    the rowmap (it indexed particles directly and silently read wrong
    rows whenever sub-box rows != sparse-table rows)."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host, run_fmax
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox

    base = dataclasses.replace(hmf_validation_params, GridSize=64,
                               recompute_displacements=True,
                               transfer_f16=False, subbox_tasks=2)
    c = hmf_validation_cosmology
    r_d = run_fmax(dataclasses.replace(base, sparse_transfer=False), c,
                   verbose=False)
    p_sp = dataclasses.replace(base, sparse_transfer=True)
    r_s = fetch_products_host(p_sp, run_fmax(p_sp, c, verbose=False))

    f_d = run_fragmentation_multibox(base, c, r_d, (2, 1, 1),
                                     verbose=False)
    f_s = run_fragmentation_multibox(p_sp, c, r_s, (2, 1, 1),
                                     verbose=False)
    assert np.array_equal(f_d.counters, f_s.counters)
    for c0, c1 in zip(f_d.catalogs, f_s.catalogs):
        o0, o1 = np.argsort(c0.name), np.argsort(c1.name)
        assert np.array_equal(c0.name[o0], c1.name[o1])
        assert np.array_equal(c0.mass[o0], c1.mass[o1])


def test_dense_segments_with_sparse_products_subbox(
        hmf_validation_params, hmf_validation_cosmology):
    """Mixed mode (review finding): DENSE vel_segments + sparse host
    products must fall back to per-box displacement copies — the rowmap
    convention cannot cover per-box [n,3] segment tables."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host, run_fmax
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox

    base = dataclasses.replace(hmf_validation_params, GridSize=64,
                               recompute_displacements=True,
                               transfer_f16=False)
    c = hmf_validation_cosmology
    # dense everything (oracle)
    r_d = run_fmax(dataclasses.replace(base, sparse_transfer=False), c,
                   verbose=False)
    f_d = run_fragmentation_multibox(base, c, r_d, (2, 1, 1),
                                     verbose=False)
    # dense segments + post-hoc sparse products on the SAME fields
    p_sp = dataclasses.replace(base, sparse_transfer=True)
    r_m = fetch_products_host(p_sp, dataclasses.replace(
        r_d, host_products=None, pending_fetch=None))
    assert r_m.vel_segments is not None and not r_m.seg_sparse
    f_m = run_fragmentation_multibox(p_sp, c, r_m, (2, 1, 1),
                                     verbose=False)
    assert np.array_equal(f_d.counters, f_m.counters)
    for c0, c1 in zip(f_d.catalogs, f_m.catalogs):
        o0, o1 = np.argsort(c0.name), np.argsort(c1.name)
        assert np.array_equal(c0.name[o0], c1.name[o1])
        assert np.array_equal(c0.mass[o0], c1.mass[o1])


def test_streaming_watermark_gates_sweep(hmf_validation_params,
                                         hmf_validation_cosmology):
    """The rows_ready watermark (groupsweep.c): with a deliberately slow
    chunk stream, the sweep starts on the delivered prefix and must
    spin-wait for every later row — if the gating were broken it would
    read uninitialized buffer rows and produce different halos.  Run
    multibox so two concurrent sweeps share one watermark."""
    import dataclasses
    import time
    from pinocchio_jax import fmax as fmax_mod
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox

    base = dataclasses.replace(hmf_validation_params, GridSize=64,
                               transfer_f16=False)
    c = hmf_validation_cosmology
    r_d = run_fmax(dataclasses.replace(base, sparse_transfer=False), c,
                   verbose=False)
    f_d = run_fragmentation_multibox(base, c, r_d, (2, 1, 1),
                                     verbose=False)

    p_sp = dataclasses.replace(base, sparse_transfer=True)
    fmax_mod._STREAM_TEST_DELAY = 0.05      # 16 chunks x 4 tables x 50 ms
    try:
        t0 = time.perf_counter()
        r_s = run_fmax(p_sp, c, verbose=False)
        assert r_s.pending_fetch is not None
        f_s = run_fragmentation_multibox(p_sp, c, r_s, (2, 1, 1),
                                         verbose=False)
        elapsed = time.perf_counter() - t0
    finally:
        fmax_mod._STREAM_TEST_DELAY = 0.0
    # the stream really was slow (so the sweep must have waited)
    assert elapsed > 0.05 * fmax_mod.N_CHUNKS / 2
    assert np.array_equal(f_d.counters, f_s.counters)
    for c0, c1 in zip(f_d.catalogs, f_s.catalogs):
        o0, o1 = np.argsort(c0.name), np.argsort(c1.name)
        assert np.array_equal(c0.name[o0], c1.name[o1])
        assert np.array_equal(c0.mass[o0], c1.mass[o1])
        assert np.allclose(c0.x[o0], c1.x[o1], atol=1e-5)
