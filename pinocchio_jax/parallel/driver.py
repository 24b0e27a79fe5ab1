"""Multi-chip fmax pipeline step.

Builds the jitted, mesh-sharded computation that the single-chip fmax loop
performs per smoothing radius, plus the displacement stage: this is the
framework's 'training step' for multi-device validation and scaling runs.
Works over either decomposition (slab 1-D mesh / pencil 2-D mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..backend import transfer_policy
from ..ops import collapse
from . import pfft


def build_fmax_step(decomp):
    """Returns a jitted function of
        (kdensity_kspace, Fmax, Rmax, R_grid, ismooth, pack)
    performing one smoothing radius: 6 distributed derivative FFTs + the
    collapse-time update, all sharded over the mesh."""
    second = pfft.distributed_second_derivatives(decomp)

    def step(kden, Fmax, Rmax, R_grid, ismooth, pack):
        sd = second(kden, R_grid)
        return collapse.collapse_update(sd, Fmax, Rmax, ismooth, pack)

    return jax.jit(step)


def build_displacement_step(decomp):
    """Zel'dovich displacement stack from the sharded kdensity."""
    first = pfft.distributed_first_derivatives(decomp)
    return jax.jit(lambda kden, growth: first(kden, growth))


def build_kdensity(decomp, grid, cosmo, seed: int,
                   fixed: bool = False, paired: bool = False):
    """delta(k) generated directly into the decomposition's k layout.

    The counter-based threefry draws partition under jit (each shard
    computes only its modes), so the realized field is bit-identical to the
    single-chip generator for any mesh — the reference's seed-plane
    task-count invariance (GenIC.c:482-1143) by construction.
    """
    import math

    from ..ic import _kdensity_jit, pk_table

    N = grid.N
    Nh = N // 2 + 1
    logk_tab, logpk_tab = pk_table(cosmo, grid)
    kf = 2.0 * math.pi / grid.BoxSize
    fac = grid.BoxSize ** -1.5 * float(N) ** 3
    padz = decomp.k_global_shape[2] - Nh

    @partial(jax.jit, out_shardings=decomp.kspace_sharding())
    def gen(key):
        k = _kdensity_jit.__wrapped__(
            key, logk_tab, logpk_tab, jnp.float32(math.log10(kf)),
            jnp.float32(fac), N, bool(fixed), bool(paired))
        return jnp.pad(k, ((0, 0), (0, 0), (0, padz)))

    return gen(jax.random.PRNGKey(seed))


def build_fmax_loop(decomp, nsmooth: int):
    """The full smoothing-radius cycle as ONE sharded device program:
    lax.scan over radii, each iteration 6 distributed derivative FFTs +
    the elementwise collapse update (the multi-chip analog of
    fmax.fmax_loop; fmax.c:66-150)."""
    N = decomp.N
    second = pfft.distributed_second_derivatives(decomp)
    rshard = jax.sharding.NamedSharding(decomp.mesh, decomp.real_spec)

    @jax.jit
    def loop(kden, radii_grid, invgrow_packs):
        Fmax0 = jax.lax.with_sharding_constraint(
            jnp.full((N, N, N), -10.0, jnp.float32), rshard)
        Rmax0 = jax.lax.with_sharding_constraint(
            jnp.full((N, N, N), -1, jnp.int32), rshard)
        sd0 = jnp.zeros((6, N, N, N), jnp.float32)

        def body(carry, xs):
            Fmax, Rmax, _ = carry
            R_grid, ism, pack = xs
            sd = second(kden, R_grid)
            Fmax, Rmax, d_avg, d_var = collapse.collapse_update.__wrapped__(
                sd, Fmax, Rmax, ism, pack)
            return (Fmax, Rmax, sd), (d_avg, d_var)

        xs = (radii_grid, jnp.arange(nsmooth, dtype=jnp.int32),
              invgrow_packs)
        (Fmax, Rmax, sd), (avgs, variances) = jax.lax.scan(
            body, (Fmax0, Rmax0, sd0), xs, length=nsmooth)
        return Fmax, Rmax, avgs, variances, sd

    return loop


def build_fmax_loop_tab(decomp, nsmooth: int, interp: str = "trilinear"):
    """build_fmax_loop variant where collapse times come from per-radius
    TABULATED_CT tables (ELL_SNG or tabulated classic): the tables are
    replicated over the mesh, the lookup (any of the three interpolation
    variants) runs per shard (interpolate_collapse_time,
    collapse_times.c:1139-1231)."""
    N = decomp.N
    second = pfft.distributed_second_derivatives(decomp)
    rshard = jax.sharding.NamedSharding(decomp.mesh, decomp.real_spec)

    @jax.jit
    def loop(kden, radii_grid, ct_tabs, ct_dv, ct_idx_map, ct_ampls,
             ct_tabs2):
        Fmax0 = jax.lax.with_sharding_constraint(
            jnp.full((N, N, N), -10.0, jnp.float32), rshard)
        Rmax0 = jax.lax.with_sharding_constraint(
            jnp.full((N, N, N), -1, jnp.int32), rshard)
        sd0 = jnp.zeros((6, N, N, N), jnp.float32)

        def body(carry, xs):
            Fmax, Rmax, _ = carry
            R_grid, ism, tab, tab2, ampl = xs
            sd = second(kden, R_grid)
            Fmax, Rmax, d_avg, d_var = \
                collapse.collapse_update_table.__wrapped__(
                    sd, Fmax, Rmax, ism, tab, ct_dv, ct_idx_map, ampl,
                    ct_tab2=tab2, interp=interp)
            return (Fmax, Rmax, sd), (d_avg, d_var)

        xs = (radii_grid, jnp.arange(nsmooth, dtype=jnp.int32), ct_tabs,
              ct_tabs2, ct_ampls)
        (Fmax, Rmax, sd), (avgs, variances) = jax.lax.scan(
            body, (Fmax0, Rmax0, sd0), xs, length=nsmooth)
        return Fmax, Rmax, avgs, variances, sd

    return loop


def distributed_lpt_sources(decomp):
    """2LPT/3LPT k-space sources from the sharded R=0 Hessian stack:
    pointwise products per shard + distributed forward/derivative FFTs
    (the multi-chip analog of ops.lpt.lpt_sources; LPT.c:32-172)."""
    from jax.sharding import PartitionSpec as P

    def local(sd):
        XX, YY, ZZ, XY, XZ, YZ = range(6)
        src2 = (sd[XX] * sd[YY] + sd[XX] * sd[ZZ] + sd[YY] * sd[ZZ]
                - sd[XY] * sd[XY] - sd[XZ] * sd[XZ] - sd[YZ] * sd[YZ])
        src31 = 3.0 * (sd[XX] * (sd[YY] * sd[ZZ] - sd[YZ] * sd[YZ])
                       - sd[XY] * (sd[XY] * sd[ZZ] - sd[XZ] * sd[YZ])
                       + sd[XZ] * (sd[XY] * sd[YZ] - sd[XZ] * sd[YY]))
        src32 = 2.0 * (sd[XX] + sd[YY] + sd[ZZ]) * src2

        kvec2 = decomp.fwd_local(src2)
        kx, ky, kz = decomp.local_kvectors()
        k2 = kx * kx + ky * ky + kz * kz
        base2 = kvec2 * pfft._safe_inv(k2).astype(jnp.float32)
        kvecs = (kx, ky, kz)
        pairs = ((0, 0, 1.0), (1, 1, 1.0), (2, 2, 1.0),
                 (0, 1, 2.0), (0, 2, 2.0), (1, 2, 2.0))
        for ider, (ia, ib, w) in enumerate(pairs):
            phi2_ij = decomp.inv_local(base2 * (kvecs[ia] * kvecs[ib]))
            src32 = src32 - 2.0 * w * phi2_ij * sd[ider]

        return kvec2, decomp.fwd_local(src31), decomp.fwd_local(src32)

    return pfft.shard_map_fn(
        decomp.mesh, local, P(None, *decomp.real_spec),
        (decomp.k_spec, decomp.k_spec, decomp.k_spec))


def build_displacement_stage(decomp, order: int, scaledep: bool = False):
    """All LPT displacement stacks as one sharded program (the multi-chip
    displacement_stage; compute_displacements, fmax.c:292-367).

    growths: scalars (D1, D2, D31, D32) when scale-independent, else
    (gtabs[4, ntab], glo, gdx) per-mode growth tables over log10 |k|."""
    first_s = pfft.distributed_first_derivatives(decomp)
    first_t = pfft.distributed_first_derivatives_tab(decomp) \
        if scaledep else None
    sources = distributed_lpt_sources(decomp)

    @jax.jit
    def stage(kden, sd, growths):
        def first(kvec, iorder):
            if scaledep:
                gtabs, glo, gdx = growths
                return first_t(kvec, gtabs[iorder], glo, gdx)
            return first_s(kvec, growths[iorder])

        out = {}
        if order >= 2:
            kvec2, kvec31, kvec32 = sources(sd)
            out["v2"] = first(kvec2, 1)
            if order >= 3:
                out["v31"] = first(kvec31, 2)
                out["v32"] = first(kvec32, 3)
        out["v1"] = first(kden, 0)
        return out

    return stage


def run_fmax_distributed(params, cosmo, mesh: Mesh, scaledep_gm=None,
                         verbose: bool = True, defer_segments: bool = None):
    """Multi-chip run_fmax: IC generation, the smoothing cycle and the LPT
    stage all sharded over the mesh, covering the full feature set of the
    single-chip path (scale-dependent growth, TABULATED_CT / ELL_SNG
    collapse, RECOMPUTE_DISPLACEMENTS segments).  Returns the same
    FmaxResult the single-chip path produces (arrays carry mesh shardings;
    np.asarray gathers)."""
    import time

    from ..fmax import (FmaxResult, Products, Smoothing, growth_k_tables,
                        inverse_growth_packs, prepare_ct_tables)
    from ..grids import Grid

    grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
    N = grid.N
    decomp = pfft.make_decomp(mesh, N)
    sm = Smoothing.build(params, cosmo)
    timings = {}

    t0 = time.perf_counter()
    kden = build_kdensity(decomp, grid, cosmo, params.RandomSeed,
                          fixed=params.FixedIC, paired=params.PairedIC)
    kden.block_until_ready()
    timings["dens"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    radii_grid = jnp.asarray(sm.radii / grid.CellSize, jnp.float32)
    if params.ell_model != "classic":
        ct = prepare_ct_tables(params, cosmo, sm, verbose=verbose)
        loop = build_fmax_loop_tab(decomp, sm.n, interp=params.ct_interp)
        Fmax, Rmax, d_avgs, d_vars, sd = loop(
            kden, radii_grid, jnp.asarray(ct["tables"]),
            jnp.asarray(ct["dv"]), jnp.asarray(ct["idx_map"]),
            jnp.asarray(ct["ampl"]), jnp.asarray(ct["tables2"]))
    else:
        packs = inverse_growth_packs(cosmo, sm, scaledep_gm)
        loop = build_fmax_loop(decomp, sm.n)
        Fmax, Rmax, d_avgs, d_vars, sd = loop(kden, radii_grid,
                                              jnp.asarray(packs))
    sm.true_variance[:] = np.asarray(d_vars)
    timings["fmax_loop"] = time.perf_counter() - t0
    if verbose:
        import math
        for ism in range(sm.n):
            print(f"  smoothing {ism + 1}/{sm.n}: R={sm.radii[ism]:9.5f} "
                  f"expected sigma {math.sqrt(sm.variance[ism]):7.4f} "
                  f"computed "
                  f"{math.sqrt(max(sm.true_variance[ism], 0.0)):7.4f}")

    t0 = time.perf_counter()
    scaledep = bool(getattr(cosmo, "scale_dep", False))

    def growths_at(z):
        if scaledep:
            return growth_k_tables(cosmo, z, N)
        return (jnp.float32(cosmo.GrowingMode(z)),
                jnp.float32(cosmo.GrowingMode_2LPT(z)),
                jnp.float32(cosmo.GrowingMode_3LPT_1(z)),
                jnp.float32(cosmo.GrowingMode_3LPT_2(z)))

    z0 = params.zlast if not params.recompute_displacements \
        else params.output_z[0]
    stage = build_displacement_stage(decomp, params.lpt_order, scaledep)
    vel = stage(kden, sd, growths_at(z0))
    for v in vel.values():
        v.block_until_ready()

    # RECOMPUTE_DISPLACEMENTS: one displacement set per output redshift
    # (compute_displacements per segment, fragment.c:398-429)
    _, f16 = transfer_policy(params)

    def _fetch(v):
        if f16:
            return np.asarray(jax.jit(
                lambda x: x.astype(jnp.float16))(v)).astype(np.float32)
        return np.asarray(v)

    vel_segments = None
    vel_segments_dev = None
    if params.recompute_displacements and len(params.output_z) > 1:
        if defer_segments is None:
            # a multi-process cluster cannot gather cross-host arrays:
            # keep segments device-sharded for the exchange to route
            defer_segments = jax.process_count() > 1
        if defer_segments:
            # segment 0 IS the products.vel set: mark it None so the
            # exchange aliases the 'v' channels instead of shipping the
            # same rows twice
            vel_segments_dev = [None]
            for zseg in params.output_z[1:]:
                vs = stage(kden, sd, growths_at(zseg))
                for v in vs.values():
                    v.block_until_ready()
                vel_segments_dev.append(vs)
        else:
            vel_segments = [{k: _fetch(v) for k, v in vel.items()}]
            for zseg in params.output_z[1:]:
                vs = stage(kden, sd, growths_at(zseg))
                vel_segments.append({k: _fetch(v) for k, v in vs.items()})
    timings["lpt"] = time.perf_counter() - t0

    products = Products(Fmax=Fmax, Rmax=Rmax, vel=vel)
    return FmaxResult(products=products, smoothing=sm, grid=grid,
                      kdensity=kden, vel_segments=vel_segments,
                      vel_segments_dev=vel_segments_dev,
                      timings=timings)


def demo_step(mesh: Mesh, N: int = 32, seed: int = 1):
    """One full multi-chip fmax step on a random field: used by
    __graft_entry__.dryrun_multichip and the scaling tests."""
    decomp = pfft.make_decomp(mesh, N)
    kshard = decomp.kspace_sharding()
    rshard = decomp.real_sharding()
    kshape = decomp.k_global_shape
    Nh = N // 2 + 1

    key = jax.random.PRNGKey(seed)

    @jax.jit
    def make_field(key):
        # draw on the unpadded rfft shape then zero-pad: the field (and
        # the step's physics) is identical for every decomposition
        k = (jax.random.normal(key, (N, N, Nh))
             + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                      (N, N, Nh))).astype(jnp.complex64)
        return jnp.pad(k, ((0, 0), (0, 0), (0, kshape[2] - Nh)))

    kden = jax.device_put(make_field(key), kshard)
    Fmax = jax.device_put(jnp.full((N, N, N), -10.0, jnp.float32), rshard)
    Rmax = jax.device_put(jnp.full((N, N, N), -1, jnp.int32), rshard)

    # linear-growth inverse fit for a D ~ a background
    from ..ops.collapse import fit_inverse_growth
    la = np.linspace(-8.0, 1.0, 256)
    pack = jnp.asarray(fit_inverse_growth(la, la))

    step = build_fmax_step(decomp)
    Fmax, Rmax, d_avg, d_var = step(kden, Fmax, Rmax, jnp.float32(2.0),
                                    jnp.int32(0), pack)
    disp = build_displacement_step(decomp)(kden, jnp.float32(1.0))
    return Fmax, Rmax, disp
