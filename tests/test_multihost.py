"""Multi-host bring-up sketch (parallel/multihost): per-host shard
fetch + sub-box ownership, unit-tested with a mocked cluster on the
8-device CPU mesh (the real jax.distributed path shares all code below
the initialize call)."""

import dataclasses
import os

import numpy as np
import pytest

from pinocchio_jax.config import HMF_VALIDATION

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def sharded_run(hmf_validation_params, hmf_validation_cosmology):
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p = dataclasses.replace(hmf_validation_params, GridSize=64)
    res = run_fmax_distributed(p, hmf_validation_cosmology,
                               pfft.make_pencil_mesh(8), verbose=False)
    return p, res


def test_initialize_cluster_single_process():
    from pinocchio_jax.parallel.multihost import initialize_cluster
    hid, n = initialize_cluster(verbose=False)      # no-op path
    assert (hid, n) == (0, 1)


def test_fetch_local_sparse_full_equals_gather(sharded_run):
    """fetch_local_sparse with no filter must equal the needed-particle
    set of the global gather."""
    from pinocchio_jax.parallel.multihost import fetch_local_sparse
    p, res = sharded_run
    sp = fetch_local_sparse(p, res, f16=False)
    F = np.asarray(res.products.Fmax).ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(sp.ci, want)
    np.testing.assert_allclose(sp.F, F[want])
    v1 = np.asarray(res.products.vel["v1"]).reshape(3, -1)
    np.testing.assert_allclose(sp.vel["v1"], v1[:, want].T)


def test_mocked_two_host_union(sharded_run):
    """Two mocked hosts (device id parity) must partition the needed set
    exactly: union == full fetch, intersection empty."""
    import jax
    from pinocchio_jax.parallel.multihost import fetch_local_sparse
    p, res = sharded_run
    full = fetch_local_sparse(p, res, f16=False)
    parts = []
    for h in range(2):
        sp = fetch_local_sparse(
            p, res, f16=False,
            device_filter=lambda d, h=h: d.id % 2 == h)
        parts.append(sp)
    ci = np.concatenate([s.ci for s in parts])
    assert len(ci) == len(full.ci)
    assert len(np.unique(ci)) == len(ci)
    np.testing.assert_array_equal(np.sort(ci), full.ci)


def test_host_subboxes_partition(hmf_validation_params,
                                 hmf_validation_cosmology):
    from pinocchio_jax.fragment.subbox import (choose_nbox,
                                               subbox_geometries)
    from pinocchio_jax.io.catalogs import largest_halo_mass
    from pinocchio_jax.parallel.multihost import host_subboxes
    p, c = hmf_validation_params, hmf_validation_cosmology
    largest = largest_halo_mass(p, c)
    geoms = subbox_geometries(p, c, largest, choose_nbox(p, c, largest, 8))
    shares = [host_subboxes(geoms, h, 4) for h in range(4)]
    assert sum(len(s) for s in shares) == len(geoms)
    seen = [g.stabl for s in shares for g in s]
    assert len(set(seen)) == len(geoms)


def test_mocked_multihost_catalog_union(hmf_validation_params,
                                        hmf_validation_cosmology,
                                        fmax_result):
    """Running the multibox fragmentation as two host-slices must yield
    the same halo set as the single-process multibox run."""
    from pinocchio_jax.fragment.subbox import (choose_nbox,
                                               run_fragmentation_multibox)
    from pinocchio_jax.io.catalogs import largest_halo_mass
    p, c = hmf_validation_params, hmf_validation_cosmology
    largest = largest_halo_mass(p, c)
    nbox = choose_nbox(p, c, largest, 4)
    full = run_fragmentation_multibox(p, c, fmax_result, nbox,
                                      largest_mass=largest, verbose=False)
    names = []
    for h in range(2):
        part = run_fragmentation_multibox(
            p, c, fmax_result, nbox, largest_mass=largest,
            host_slice=(h, 2), verbose=False)
        names.append(part.catalogs[-1].name)
    union = np.concatenate(names)
    assert len(np.unique(union)) == len(union)
    np.testing.assert_array_equal(np.sort(union),
                                  np.sort(full.catalogs[-1].name))


@pytest.mark.slow
def test_real_two_process_cluster(tmp_path):
    """Boot a REAL 2-process jax.distributed cluster on CPU (the
    MPI_Init analog, pinocchio.c:41-52) and run the full multi-host
    pipeline through it: sharded fmax over the global 8-device mesh
    (cross-process gloo collectives in the FFT all_to_alls), the packed
    sparse cross-host exchange, per-host sub-box sweeps, .out.<h> catalog
    chunks — then assert the merged halo set equals an in-process
    single-host run of the same configuration (VERDICT r2 item 8)."""
    import os
    import socket
    import subprocess
    import sys

    # free local port for the coordinator
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    multi = tmp_path / "multi"
    os.makedirs(multi)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for h in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pinocchio_jax.run",
             HMF_VALIDATION,
             "--norad", "--grid", "64", "--subboxes", "2", "--chips", "8",
             "--platform", "cpu", "--hosts", "2", "--host-id", str(h),
             "--coordinator", f"localhost:{port}",
             "--outdir", str(multi)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for h, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=600)
        outs.append(out)
        assert pr.returncode == 0, f"host {h} failed:\n{out}"
    assert "[cluster] process 0/2 up" in outs[0]
    assert "[cluster] process 1/2 up" in outs[1]

    # the same configuration in-process, single host, same 8-device mesh
    import dataclasses
    from pinocchio_jax.config import read_parameter_file
    from pinocchio_jax.run import run_pipeline
    p = read_parameter_file(HMF_VALIDATION, norad=True)
    p = dataclasses.replace(p, GridSize=64, subbox_tasks=2)
    single = tmp_path / "single"
    os.makedirs(single)
    run_pipeline(p, outdir=str(single), verbose=False, chips=8)

    from pinocchio_jax.io import readers
    base = "pinocchio.0.0000.test.catalog.out"
    a = readers.read_catalog(str(single / base))
    chunks = [readers.read_catalog(str(multi / f"{base}.{h}"))
              for h in range(2)]
    names_multi = np.concatenate([c["name"] for c in chunks])
    assert len(np.unique(names_multi)) == len(names_multi)
    assert len(a) == len(names_multi)
    np.testing.assert_array_equal(np.sort(a["name"]),
                                  np.sort(names_multi))


def test_merge_chunks_tool(hmf_validation_params, tmp_path):
    """Two mocked-host run_pipeline invocations write .out.<h> chunks;
    scripts/merge_chunks.py must reassemble the single-process files and
    recompute the mass function from the merged catalog."""
    import dataclasses
    import importlib.util
    import os
    from pinocchio_jax.run import run_pipeline

    p = dataclasses.replace(hmf_validation_params, GridSize=64,
                            output_z=(0.0,), CatalogInAscii=False,
                            plc_enabled=True, StartingzForPLC=0.3,
                            LastzForPLC=0.0)
    single = tmp_path / "single"
    multi = tmp_path / "multi"
    os.makedirs(single), os.makedirs(multi)
    run_pipeline(p, outdir=str(single), verbose=False)
    p2 = dataclasses.replace(p, subbox_tasks=2)
    for h in range(2):
        run_pipeline(p2, outdir=str(multi), verbose=False, hosts=(h, 2))

    chunks = sorted(os.listdir(multi))
    assert any(f.endswith(".catalog.out.0") for f in chunks)
    assert any(f.endswith(".catalog.out.1") for f in chunks)

    # in-run multi-host mass function + n(z) (VERDICT r3 item 6): the
    # per-host bin histograms reduce through part files and the last
    # host writes the final files — identical to the single-process run,
    # no merge_chunks needed, no part files left behind
    assert not any(".part" in f for f in chunks)
    mf_inrun = np.loadtxt(str(multi / "pinocchio.0.0000.test.mf.out"))
    mf_single = np.loadtxt(str(single / "pinocchio.0.0000.test.mf.out"))
    np.testing.assert_allclose(mf_inrun[:, 4], mf_single[:, 4])
    np.testing.assert_allclose(mf_inrun[:, 1], mf_single[:, 1],
                               rtol=1e-6)
    nz_inrun = np.loadtxt(str(multi / "pinocchio.test.nz.out"))
    nz_single = np.loadtxt(str(single / "pinocchio.test.nz.out"))
    np.testing.assert_allclose(nz_inrun[:, 2], nz_single[:, 2])

    # the tool reads the run's parameter file: give it one that matches
    # this test's overrides (GridSize 64, single z=0 output)
    src = open(HMF_VALIDATION).read()
    src = src.replace("GridSize               128",
                      "GridSize               64")
    pf = tmp_path / "parameter_file"
    pf.write_text(src)
    (tmp_path / "outputs").write_text("0.0\n")

    spec = importlib.util.spec_from_file_location(
        "merge_chunks", os.path.join(REPO, "scripts", "merge_chunks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main([str(pf), "--dir", str(multi)])

    from pinocchio_jax.io import readers
    a = readers.read_catalog(str(single / "pinocchio.0.0000.test"
                                          ".catalog.out"))
    b = readers.read_catalog(str(multi / "pinocchio.0.0000.test"
                                         ".catalog.out"))
    assert len(a) == len(b)
    oa, ob = np.argsort(a["name"]), np.argsort(b["name"])
    np.testing.assert_array_equal(a["name"][oa], b["name"][ob])
    np.testing.assert_array_equal(a["n"][oa], b["n"][ob])
    mf = np.loadtxt(str(multi / "pinocchio.0.0000.test.mf.out"))
    mf_ref = np.loadtxt(str(single / "pinocchio.0.0000.test.mf.out"))
    np.testing.assert_allclose(mf[:, 4], mf_ref[:, 4])

    # merged histories: summed global counts, all trees parse
    n1, t1 = readers.read_histories(
        str(single / "pinocchio.test.histories.out"))
    n2, t2 = readers.read_histories(
        str(multi / "pinocchio.test.histories.out"))
    assert n2 == n1 == len(t2)
    assert sum(len(t) for t in t2) == sum(len(t) for t in t1)

    # merged PLC parses and matches the single-process population
    plc1 = readers.read_plc(str(single / "pinocchio.test.plc.out"))
    plc2 = readers.read_plc(str(multi / "pinocchio.test.plc.out"))
    assert len(plc2) == len(plc1)
    np.testing.assert_array_equal(np.sort(plc2["name"]),
                                  np.sort(plc1["name"]))
    # recomputed n(z) exists
    assert (multi / "pinocchio.test.nz.out").exists()
