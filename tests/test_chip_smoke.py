"""chip_smoke.py's phases at small sizes on the CPU mesh, and its refusal
to run anywhere but on a GPU (the phases themselves run on the card
through `python chip_smoke.py`)."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hessian_phase(smoke):
    r = smoke.phase_hessian(32, 32, repeats=1)
    assert len(r["errors"]) == 6 and max(r["errors"]) < smoke.HESSIAN_TOL
    assert r["fmax_loop_s"] > 0.0 and r["nsmooth"] > 1


def test_hessian_reference_is_real_and_symmetric(smoke):
    """The float64 reference of the diagonal components sums to the
    smoothed density: xx + yy + zz = delta_R (the Laplacian identity)."""
    rng = np.random.default_rng(3)
    N = 16
    field = rng.standard_normal((N, N, N))
    kden = np.fft.rfftn(field)
    xx, yy, zz, *_ = smoke.hessian_reference(kden, 0.0, N)
    expect = field - field.mean()
    np.testing.assert_allclose(xx + yy + zz, expect, atol=1e-10)


def test_engines_phase(smoke):
    r = smoke.phase_engines(32)
    assert r["collapsed"] > 0 and set(r["dv"]) == {"v1", "v2", "v31",
                                                    "v32"}


def test_end_to_end_phase(smoke, tmp_path):
    r = smoke.phase_end_to_end(128, str(tmp_path), subbox_tasks=2)
    assert r["hmf_residual"] < smoke.HMF_RESIDUAL_LIMIT
    assert r["wall_s"] > 0.0 and r["cold_s"] >= r["compile_s"] >= 0.0
    assert "fmax_fmax_loop" in r["timings"]


def test_four_phase_on_cpu_mesh(smoke):
    r = smoke.phase_four(32, 32, n=4)
    assert set(r) == {"pencil", "slab", "ooc"}


def test_compare_fields_catches_mismatch():
    from pinocchio_jax.parity import ParityError, compare_fields
    rng = np.random.default_rng(0)
    F = rng.uniform(-1, 3, (16, 16, 16)).astype(np.float32)
    v = {"v1": rng.standard_normal((3, 16, 16, 16)).astype(np.float32)}
    compare_fields("same", 16, F, F.copy(), v, dict(v))
    bad = {"v1": v["v1"] * (1.0 + 1e-3)}
    with pytest.raises(ParityError, match="displacements"):
        compare_fields("scaled", 16, F, F, v, bad)
    flipped = F.copy()
    flipped.ravel()[:100] += 1.0
    with pytest.raises(ParityError, match="flips"):
        compare_fields("flipped", 16, F, flipped, v, v)


def test_match_rows_needs_common_cells():
    from pinocchio_jax.parity import ParityError, match_rows
    ref = np.arange(0, 4000, 2)
    i_ref, i = match_rows(ref, ref[::-1].copy())
    assert np.array_equal(ref[i_ref], ref[::-1][i])
    with pytest.raises(ParityError, match="share"):
        match_rows(ref, ref[:1990])


def test_phase_device_refuses_cpu(smoke):
    with pytest.raises(smoke.SmokeFailure, match="not on a GPU"):
        smoke.phase_device(1)


def _run_alone(script_dir, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_main_refuses_cpu():
    r = _run_alone(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not on a GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_alone(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_parity_phases_on_gpu(smoke, gpu_device):
    """The Hessian and engine-parity phases as compiled for the card, at
    a grid small enough for a test run."""
    r = smoke.phase_hessian(64, 64, repeats=1)
    assert max(r["errors"]) < smoke.HESSIAN_TOL
    r = smoke.phase_engines(64)
    assert max(r["dv"].values()) < 1e-4
