import os

# Force a virtual 8-device CPU mesh for all tests: sharding code paths are
# exercised without real multi-device hardware (chip_smoke.py runs the GPU).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# a checkout of the reference PINOCCHIO V5.1, whose shipped outputs some
# tests compare with; they skip when it is not given
REFERENCE = os.environ.get("PINOCCHIO_REFERENCE", "")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test (subprocess "
        "cluster boots, big-grid regressions)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU and skips elsewhere (on the "
        "card: JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu)")


@pytest.fixture
def gpu_device():
    """The first GPU device; the test skips when JAX has none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.fixture(scope="session")
def reference_file():
    """reference_file(rel) -> path of a file shipped with the reference
    checkout named by PINOCCHIO_REFERENCE; the calling test skips when
    the file is not there."""
    def path(rel):
        p = os.path.join(REFERENCE, rel)
        if not REFERENCE or not os.path.exists(p):
            pytest.skip(f"reference file {rel} not available "
                        "(set PINOCCHIO_REFERENCE to a PINOCCHIO V5.1 "
                        "checkout)")
        return p
    return path


@pytest.fixture(scope="session")
def hmf_validation_params():
    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    # the validation run was built with
    # -DTWO_LPT -DTHREE_LPT -DELL_CLASSIC -DNORADIATION
    return read_parameter_file(HMF_VALIDATION, norad=True,
                               plc_enabled=False)


@pytest.fixture(scope="session")
def hmf_validation_cosmology(hmf_validation_params):
    from pinocchio_jax.cosmology import Cosmology
    return Cosmology(hmf_validation_params)


@pytest.fixture(scope="session")
def fmax_result(hmf_validation_params, hmf_validation_cosmology):
    from pinocchio_jax.fmax import run_fmax
    return run_fmax(hmf_validation_params, hmf_validation_cosmology,
                    verbose=False)


@pytest.fixture(scope="session")
def camb_tables(tmp_path_factory):
    """Parameter overrides for a READ_PK_TABLE run on a CAMB-format table
    set of the validation cosmology, written by scripts/make_camb_inputs.py
    (plain LCDM growth, the reference's SCALE_DEP_LCDM scenario)."""
    import importlib.util

    from pinocchio_jax.config import HMF_VALIDATION
    out = tmp_path_factory.mktemp("camb")
    spec = importlib.util.spec_from_file_location(
        "make_camb_inputs", os.path.join(os.path.dirname(__file__), "..",
                                         "scripts", "make_camb_inputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([HMF_VALIDATION, "--outdir", str(out), "--nz", "60",
                     "--norad"]) == 0
    return dict(FileWithInputSpectrum="CAMBTable",
                CAMBMatterFile=str(out / "pk_cb"),
                CAMBRedshiftsFile=str(out / "redshifts.dat"),
                HubbleTableFile=str(out / "hubble.dat"))


@pytest.fixture(scope="session")
def reference_cosmology_table(reference_file):
    """Columns of HMF_Validation/pinocchio.test.cosmology.out (oracle)."""
    return np.loadtxt(reference_file(
        "HMF_Validation/pinocchio.test.cosmology.out"))
