"""Distributed FFT decompositions vs np.fft on the virtual 8-device mesh.

The reference validates its PFFT layer implicitly via the sigma(R)
self-consistency check (fmax.c:143-146); here the slab and pencil paths are
checked field-level against the single-chip rfftn/irfftn round trip and the
single-chip derivative kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pinocchio_jax.parallel import pfft
from pinocchio_jax.parallel.driver import demo_step

N = 32


def _meshes():
    out = [("slab", pfft.make_mesh(8))]
    out.append(("pencil42", pfft.make_pencil_mesh(8)))          # 4x2
    out.append(("pencil24", pfft.make_pencil_mesh(8, (2, 4))))  # 2x4
    out.append(("vol222", pfft.make_volume_mesh(8)))            # 2x2x2
    out.append(("vol421", pfft.make_volume_mesh(8, (4, 2, 1))))
    return out


@pytest.mark.parametrize("name,mesh", _meshes(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_roundtrip_and_forward(name, mesh):
    decomp = pfft.make_decomp(mesh, N)
    rng = np.random.default_rng(7)
    r = rng.standard_normal((N, N, N)).astype(np.float32)

    fwd = jax.jit(pfft.distributed_rfft3(decomp))
    inv = jax.jit(pfft.distributed_irfft3(decomp))

    rdev = jax.device_put(r, decomp.real_sharding())
    k = fwd(rdev)
    assert k.shape == decomp.k_global_shape

    # forward matches np.fft.rfftn on the unpadded region
    Nh = N // 2 + 1
    k_np = np.fft.rfftn(r)
    got = np.asarray(k)[:, :, :Nh]
    assert np.allclose(got, k_np, rtol=2e-4, atol=2e-2)
    # padded kz planes (pencil only) are exactly zero
    if decomp.k_global_shape[2] > Nh:
        assert np.all(np.asarray(k)[:, :, Nh:] == 0)

    back = np.asarray(inv(k))            # ifft chain is fully normalized
    assert np.allclose(back, r, atol=1e-4)


@pytest.mark.parametrize("name,mesh", _meshes(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_second_derivatives_match_single_chip(name, mesh):
    from pinocchio_jax.ops import derivatives
    decomp = pfft.make_decomp(mesh, N)
    rng = np.random.default_rng(3)
    Nh = N // 2 + 1
    kden_np = (rng.standard_normal((N, N, Nh))
               + 1j * rng.standard_normal((N, N, Nh))).astype(np.complex64)
    R_grid = jnp.float32(1.5)

    ref = np.asarray(jax.jit(
        lambda kd: derivatives.second_derivatives(kd, R_grid, N)
    )(kden_np))

    kpad = np.zeros(decomp.k_global_shape, np.complex64)
    kpad[:, :, :Nh] = kden_np
    kdev = jax.device_put(kpad, decomp.kspace_sharding())
    got = np.asarray(jax.jit(
        pfft.distributed_second_derivatives(decomp))(kdev, R_grid))
    assert got.shape == (6, N, N, N)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-4 * scale


@pytest.fixture(scope="module")
def small_setup():
    from pinocchio_jax.config import read_parameter_file
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.config import HMF_VALIDATION
    p = read_parameter_file(HMF_VALIDATION, norad=True, plc_enabled=False)
    p.GridSize = N
    p.BoxSize = float(N)
    return p, Cosmology(p)


def test_distributed_kdensity_bitexact(small_setup):
    """The sharded IC generator realizes the SAME field as single-chip for
    any mesh: the reference's seed-plane task-count invariance
    (GenIC.c:482-1143), here exact because threefry is counter-based."""
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    from pinocchio_jax.parallel.driver import build_kdensity
    p, cosmo = small_setup
    grid = Grid(N=N, BoxSize=p.BoxSize_htrue)
    ref = np.asarray(generate_kdensity(grid, cosmo, p.RandomSeed))
    Nh = N // 2 + 1
    for mesh in (pfft.make_mesh(8), pfft.make_pencil_mesh(8),
                 pfft.make_volume_mesh(8)):
        d = pfft.make_decomp(mesh, N)
        got = np.asarray(build_kdensity(d, grid, cosmo,
                                        p.RandomSeed))[:, :, :Nh]
        assert np.array_equal(got, ref)


def test_run_fmax_distributed_matches_single_chip(small_setup):
    """Full sharded fmax (IC + radius scan + LPT) vs the single-chip path:
    displacements at fp32 roundoff; Fmax statistically identical (the
    branchy ellipsoid solve may flip a handful of near-degenerate cells
    when the FFT summation order changes, as with the reference's MPI
    decompositions)."""
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p, cosmo = small_setup
    ref = run_fmax(p, cosmo, verbose=False)
    F_ref = np.asarray(ref.products.Fmax)
    r = run_fmax_distributed(p, cosmo, pfft.make_pencil_mesh(8),
                             verbose=False)
    F = np.asarray(r.products.Fmax)
    for key in ref.products.vel:
        a = np.asarray(ref.products.vel[key])
        b = np.asarray(r.products.vel[key])
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-3), key
    assert np.allclose(r.smoothing.true_variance,
                       ref.smoothing.true_variance, rtol=1e-4)
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    assert nflip < 30, f"{nflip} collapse-branch flips"
    c_ref = int((F_ref >= 1.0).sum())
    c = int((F >= 1.0).sum())
    assert abs(c - c_ref) <= max(5, c_ref // 1000)


def test_run_fmax_distributed_volume_matches_single_chip(small_setup):
    """Full sharded fmax on the 3-D volumes mesh (2x2x2: three subgroup
    all_to_alls per transform) vs the single-chip path."""
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p, cosmo = small_setup
    ref = run_fmax(p, cosmo, verbose=False)
    F_ref = np.asarray(ref.products.Fmax)
    r = run_fmax_distributed(p, cosmo, pfft.make_volume_mesh(8),
                             verbose=False)
    F = np.asarray(r.products.Fmax)
    for key in ref.products.vel:
        a = np.asarray(ref.products.vel[key])
        b = np.asarray(r.products.vel[key])
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-3), key
    assert np.allclose(r.smoothing.true_variance,
                       ref.smoothing.true_variance, rtol=1e-4)
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    assert nflip < 30, f"{nflip} collapse-branch flips"


def test_distributed_tabulated_matches_single_chip(small_setup):
    """Sharded fmax with TABULATED_CT collapse (the classic-model tables)
    vs the single-chip tabulated path: same tables, same lookup per
    shard."""
    import dataclasses
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p, cosmo = small_setup
    p = dataclasses.replace(p, ell_model="tabulated")
    ref = run_fmax(p, cosmo, verbose=False)
    r = run_fmax_distributed(p, cosmo, pfft.make_pencil_mesh(8),
                             verbose=False)
    F_ref = np.asarray(ref.products.Fmax)
    F = np.asarray(r.products.Fmax)
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    assert nflip < 30, f"{nflip} collapse flips"
    c_ref = int((F_ref >= 1.0).sum())
    assert abs(int((F >= 1.0).sum()) - c_ref) <= max(5, c_ref // 1000)


def test_distributed_recompute_segments(small_setup):
    """RECOMPUTE_DISPLACEMENTS multi-chip: one displacement set per output
    redshift, each matching the single-chip segment."""
    import dataclasses
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p, cosmo = small_setup
    p = dataclasses.replace(p, recompute_displacements=True,
                            transfer_f16=False)
    assert len(p.output_z) > 1
    ref = run_fmax(p, cosmo, verbose=False)
    r = run_fmax_distributed(p, cosmo, pfft.make_mesh(8), verbose=False)
    assert r.vel_segments is not None
    assert len(r.vel_segments) == len(p.output_z) == len(ref.vel_segments)
    for seg_ref, seg in zip(ref.vel_segments, r.vel_segments):
        for key in seg_ref:
            a, b = seg_ref[key], seg[key]
            assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-3)


def test_distributed_scaledep_matches_single_chip(hmf_validation_params,
                                                 camb_tables):
    """Sharded fmax with scale-dependent growth (CAMB-table cosmology):
    per-radius inverse-growth packs and per-mode growth tables in the
    displacement stage, vs the single-chip path."""
    import dataclasses
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fmax import Smoothing, run_fmax
    from pinocchio_jax.io import catalogs as io_cat
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    from pinocchio_jax.scaledep import set_scaledep_gm
    p = dataclasses.replace(hmf_validation_params, **camb_tables)
    p.validate()
    p.GridSize = N
    p.BoxSize = float(N) * 4.0
    p.recompute_displacements = False
    p.transfer_f16 = False
    cosmo = Cosmology(p)
    assert cosmo.scale_dep
    gm = set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                         io_cat.largest_halo_mass(p, cosmo), verbose=False)
    ref = run_fmax(p, cosmo, scaledep_gm=gm, verbose=False)
    r = run_fmax_distributed(p, cosmo, pfft.make_pencil_mesh(8),
                             scaledep_gm=gm, verbose=False)
    F_ref = np.asarray(ref.products.Fmax)
    F = np.asarray(r.products.Fmax)
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    assert nflip < 30, f"{nflip} collapse flips"
    for key in ref.products.vel:
        a = np.asarray(ref.products.vel[key])
        b = np.asarray(r.products.vel[key])
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-3), key


def test_demo_step_pencil():
    Fmax, Rmax, disp = demo_step(pfft.make_pencil_mesh(8), N=N)
    assert Fmax.shape == (N, N, N)
    assert disp.shape == (3, N, N, N)
    assert np.isfinite(np.asarray(Fmax)).all()
    # the same step on a slab mesh gives identical physics
    Fs, _, ds = demo_step(pfft.make_mesh(8), N=N)
    assert np.allclose(np.asarray(Fmax), np.asarray(Fs), atol=1e-3)
    assert np.allclose(np.asarray(disp), np.asarray(ds), atol=1e-3)
