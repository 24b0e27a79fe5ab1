"""The device policy, the compile-cache location, the planner's device
memory model and the native library cache key."""

import dataclasses
import os

import pytest

from pinocchio_jax.config import Params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,expected", [("gpu", (True, False)),
                                               ("cpu", (False, False))])
def test_transfer_policy_defaults(platform, expected):
    from pinocchio_jax.backend import transfer_policy
    assert transfer_policy(Params(), platform=platform) == expected


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_transfer_policy_overrides(platform):
    from pinocchio_jax.backend import transfer_policy
    p = Params(sparse_transfer=False, transfer_f16=True)
    assert transfer_policy(p, platform=platform) == (False, True)
    p = Params(sparse_transfer=True, transfer_f16=False)
    assert transfer_policy(p, platform=platform) == (True, False)


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_transfer_policy_refuses_unknown_platform(platform, monkeypatch):
    import jax

    from pinocchio_jax.backend import transfer_policy
    if not platform:
        # no explicit platform: the one JAX runs on decides
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no device policy"):
        transfer_policy(Params(), platform=platform or None)


def test_transfer_policy_follows_jax_backend():
    from pinocchio_jax.backend import transfer_policy
    assert transfer_policy(Params()) == (False, False)      # tests: cpu


@pytest.mark.parametrize("n", [8, 9])
def test_irfft_z_takes_edge_planes_real(n):
    """c2r of a half spectrum whose kz=0 (and, for even n, kz=n/2)
    entries are not real: the result is the explicit real-part sum, the
    same on every FFT library."""
    import jax.numpy as jnp
    import numpy as np

    from pinocchio_jax.backend import irfft_z
    rng = np.random.default_rng(n)
    nh = n // 2 + 1
    u = (rng.standard_normal((3, nh))
         + 1j * rng.standard_normal((3, nh))).astype(np.complex64)
    z = np.arange(n)
    w = np.where((np.arange(nh) == 0) | (2 * np.arange(nh) == n), 1.0, 2.0)
    expect = np.real((w * u.astype(np.complex128))[:, :, None]
                     * np.exp(2j * np.pi * np.arange(nh)[:, None] * z / n)
                     ).sum(axis=1) / n
    got = np.asarray(irfft_z(jnp.asarray(u), n))
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_cache_dir_honours_environment():
    from pinocchio_jax.backend import cache_dir
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where/cache"}
    assert cache_dir(env) == "/some/where/cache"


def test_cache_dir_fixed_in_checkout():
    from pinocchio_jax.backend import cache_dir
    assert cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == cache_dir({})


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fd:
        assert ".jax_cache/" in fd.read().split()


def test_device_memory_bytes_cpu():
    from pinocchio_jax.planner import device_memory_bytes
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_memory_bytes() == float(ram)


def test_plan_uses_given_device_size(hmf_validation_params,
                                     hmf_validation_cosmology):
    from pinocchio_jax.planner import GB, plan
    p = dataclasses.replace(hmf_validation_params, GridSize=512)
    r80 = plan(p, hbm_gb=80.0, verbose=False, cosmo=hmf_validation_cosmology)
    r8 = plan(p, hbm_gb=8.0, verbose=False, cosmo=hmf_validation_cosmology)
    assert r80["device_limit"] == 80.0 * GB and r80["fits_hbm"]
    assert not r8["fits_hbm"]


def test_ooc_storage_dtype_from_ledger(hmf_validation_params):
    from pinocchio_jax.planner import GB, ooc_device_peak, ooc_storage_dtype
    p = dataclasses.replace(hmf_validation_params, GridSize=1024)
    f32 = ooc_device_peak(p, dtype="float32")
    bf16 = ooc_device_peak(p, dtype="bfloat16")
    assert bf16 < f32 < 80.0 * GB       # 1024^3 float32 fits an H100
    assert ooc_storage_dtype(p, limit=80.0 * GB) == "float32"
    assert ooc_storage_dtype(p, limit=0.5 * (f32 + bf16)) == "bfloat16"
    # two cards halve the per-card ledger
    assert ooc_storage_dtype(p, n_chips=2, limit=0.6 * f32) == "float32"
    # an explicit dtype wins
    p16 = dataclasses.replace(p, ooc_dtype="bfloat16")
    assert ooc_storage_dtype(p16, limit=80.0 * GB) == "bfloat16"


def test_ooc_engine_dtypes_follow_storage(hmf_validation_params,
                                          hmf_validation_cosmology):
    import jax.numpy as jnp

    from pinocchio_jax.fmax_ooc import OocEngine
    p = dataclasses.replace(hmf_validation_params, GridSize=16)
    eng = OocEngine(p, hmf_validation_cosmology, verbose=False)
    assert eng.dtype == jnp.float32 and eng.fdtype == jnp.float32
    p = dataclasses.replace(p, ooc_dtype="bfloat16")
    eng = OocEngine(p, hmf_validation_cosmology, verbose=False)
    assert eng.dtype == jnp.bfloat16 and eng.fdtype == jnp.float16


def test_native_key_tracks_source_flags_and_cpu():
    from pinocchio_jax import native
    k = native.library_key(b"int f(void);", cpu="cpu A")
    assert k == native.library_key(b"int f(void);", cpu="cpu A")
    assert k != native.library_key(b"int g(void);", cpu="cpu A")
    assert k != native.library_key(b"int f(void);", cpu="cpu B")
    assert k != native.library_key(b"int f(void);", flags=["-O0"],
                                   cpu="cpu A")
    assert native.host_cpu()


def test_native_library_built_outside_source(monkeypatch, tmp_path):
    """The library lands in the build directory under its key; another
    CPU identity builds (and names) a separate one."""
    from pinocchio_jax import native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    lib = native._build("fastio")
    assert os.path.dirname(lib) == str(tmp_path)
    with open(os.path.join(native._HERE, "fastio.c"), "rb") as fd:
        assert os.path.basename(lib) == \
            f"libfastio-{native.library_key(fd.read())}.so"
    monkeypatch.setattr(native, "host_cpu", lambda: "another cpu")
    other = native._build("fastio")
    assert other != lib and os.path.exists(other) and os.path.exists(lib)
    assert not [f for f in os.listdir(native._HERE) if f.endswith(".so")]


def test_native_build_failure_is_loud(monkeypatch, tmp_path):
    from pinocchio_jax import native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    (tmp_path / "broken.c").write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="failed to build broken"):
        native._build("broken")
