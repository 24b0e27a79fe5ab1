"""End-to-end run of the SHIPPED example configuration (CAMB P(k) tables
+ scale-dependent growth + RECOMPUTE_DISPLACEMENTS + past light cone,
example/parameter_file) through the full sparse-transfer path, validated
statistically against the shipped example catalogs (different RNG
realization: counts compare at the Poisson level)."""

import os

import numpy as np
import pytest

# shipped catalog populations (grep -vc '^#' pinocchio.<z>.example.catalog.out)
REF_COUNTS = {0.0: 9461, 0.5: 5919, 1.0: 2591, 2.0: 136}


@pytest.fixture(scope="module")
def example_dir(reference_file):
    """The reference's shipped example run (inputs and outputs)."""
    return os.path.dirname(reference_file("example/parameter_file"))


@pytest.fixture(scope="module")
def example_run(tmp_path_factory, example_dir):
    from pinocchio_jax.config import read_parameter_file
    from pinocchio_jax.run import run_pipeline
    p = read_parameter_file(os.path.join(example_dir, "parameter_file"))
    # the full accelerator-path feature set on the CPU mesh: sparse
    # overlapped fetch + sparse RECOMPUTE segments (exact f32 wire)
    p.sparse_transfer = True
    p.transfer_f16 = False
    out = str(tmp_path_factory.mktemp("example_e2e"))
    res = run_pipeline(p, outdir=out, verbose=False, write_outputs=True)
    return p, res, out


def test_example_halo_counts(example_run):
    p, res, _ = example_run
    # segments rode the sparse path (fragmentation consumed a replaced
    # copy; the original keeps the resolved PendingFetch)
    pf = res["fmax"].pending_fetch
    assert pf is not None and pf.segments is not None
    for snap in res["frag"].catalogs:
        ngood = int((snap.mass >= p.MinHaloMass).sum())
        ref = REF_COUNTS[snap.z]
        # different realization: Poisson + cosmic variance margin
        assert abs(ngood - ref) < max(0.05 * ref, 5.0 * np.sqrt(ref)), \
            (snap.z, ngood, ref)


def test_example_mf_vs_shipped(example_run, example_dir):
    p, _, out = example_run
    mine = np.loadtxt(os.path.join(out, "pinocchio.0.0000.example.mf.out"))
    ref = np.loadtxt(os.path.join(example_dir,
                                  "pinocchio.0.0000.example.mf.out"))
    n = min(len(mine), len(ref))
    cm, cr = mine[:n, 4], ref[:n, 4]
    good = (cm > 100) & (cr > 100)
    assert good.sum() >= 4
    assert np.abs(cm[good] / cr[good] - 1.0).max() < 0.2
    assert abs(cm.sum() / cr.sum() - 1.0) < 0.05


def test_example_plc_populated(example_run):
    p, res, out = example_run
    plc = res["frag"].plc
    assert plc is not None and not plc.overflow
    assert len(plc.z) > 1000               # the cone out to z=0.3 fills
    assert (plc.z <= p.StartingzForPLC + 0.05).all()
    assert os.path.exists(os.path.join(out, "pinocchio.example.plc.out"))
    assert os.path.exists(os.path.join(out, "pinocchio.example.nz.out"))


def test_example_histories_size(example_run, example_dir):
    _, res, out = example_run
    path = os.path.join(out, "pinocchio.example.histories.out")
    with open(path) as fd:
        rows = sum(1 for line in fd if not line.startswith("#"))
    with open(os.path.join(example_dir,
                           "pinocchio.example.histories.out")) as fd:
        ref_rows = sum(1 for line in fd if not line.startswith("#"))
    assert abs(rows / ref_rows - 1.0) < 0.05
