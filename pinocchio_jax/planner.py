"""Run planner + runtime memory budget: predict memory and decomposition
for a planned run without allocating, and enforce the budget pre-flight.

Analog of the reference's run_planner tool (run_planner.c:44-427,
DOCUMENTATION:786-797) and of its pre-flight memory organization + abort
(organize_main_memory / pre-allocation test, allocations.c:37-251,317-324),
built on this engine's memory model instead of the MPI arena: per-chip HBM
for the fmax stage, host memory for fragmentation, sub-box decomposition
and boundary overhead, output file sizes.

Usage: python -m pinocchio_jax.planner <parameter_file> [--chips N]
       [--hbm-gb G] [--subboxes N] [--sweep]

The device limit is the detected one (memory_stats()["bytes_limit"] on
the GPU, physical memory on the CPU); --hbm-gb replaces it for offline
planning of a device this process does not see.
"""

from __future__ import annotations

import argparse
import math

from .config import Params, read_parameter_file
from .cosmology import Cosmology

GB = 1024.0 ** 3
MB = 1024.0 ** 2
F4 = 4                      # fp32 product bytes
DELTA_C = 1.686


class MemoryPlanError(MemoryError):
    """Predicted memory exceeds the configured budget (the analog of the
    reference's pre-flight abort, allocations.c:317-324)."""


def collapsed_fraction(params: Params, cosmo: Cosmology, sm=None) -> float:
    """Predicted fraction of particles with Fmax >= 1+zlast — the host
    memory driver under the V5 needed-particle model.

    2*sf(delta_c / (sigma_grid * D(zlast))): Press-Schechter counting of
    |delta| > delta_c at the grid-scale linear variance.  Calibrated
    against measured runs (this engine, round 2): HMF_Validation 128^3
    measured 0.590 vs 0.602 predicted; example 128^3 measured 0.328 vs
    0.430 predicted — a tight, slightly conservative upper bound (the
    reference instead derives Nstored from the products it has already
    computed, fragment.c:294-301; a planner must predict it).
    """
    from scipy.stats import norm as gauss
    if sm is None:
        from .fmax import Smoothing
        sm = Smoothing.build(params, cosmo)
    sigma = math.sqrt(sm.variance[-1])
    D = float(cosmo.GrowingMode(params.zlast, params.k_for_GM))
    return min(1.0, 2.0 * float(gauss.sf(DELTA_C / (sigma * D))))


def device_memory_bytes() -> float:
    """Per-device memory limit of the first local device: the allocator's
    bytes_limit on a GPU (a GPU that reports none is an error), the
    physical memory on the CPU, where device arrays live in host RAM."""
    import os

    import jax
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return float(os.sysconf("SC_PAGE_SIZE")
                     * os.sysconf("SC_PHYS_PAGES"))
    if dev.platform != "gpu":
        raise RuntimeError(f"no memory model for platform {dev.platform!r}")
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"{dev.device_kind} reports no memory limit")
    return float(limit)


def ooc_device_peak(params: Params, frac: float = 0.8,
                    n_chips: int = 1, dtype: str = None) -> float:
    """Device peak PER CHIP of the out-of-core engine (fmax_ooc.py
    module ledger): max of the collapse-cycle phase (6-component
    half-transform stack + the Fmax grid) and the v-stream phase
    (3-component stack + three resident source spectra + the padded
    needed-index table, which scales with the collapsed fraction
    `frac`).  n_chips > 1: every ledger component shards over the mesh
    (stacks/spectra by kz plane, Fmax/idx by z-slab row —
    OocEngine(mesh=...)), so the per-chip peak divides by the chip
    count.  dtype: the half-transform storage dtype (default: the one
    ooc_storage_dtype picks); float16 Fmax rows go with bfloat16
    storage, float32 rows with float32 storage."""
    N = params.GridSize
    Nh = N // 2 + 1
    dtype = dtype or ooc_storage_dtype(params, n_chips)
    store = 4 if dtype == "float32" else 2
    half = 2 * Nh * float(N) ** 2 * store / n_chips   # one re+im pair
    fmax = float(N) ** 3 * store / n_chips
    cycle = 6 * half + fmax
    spec = 2 * Nh * float(N) ** 2 * store / n_chips   # one spectrum
    # the real table is padded to nsl * cap with cap ~ 1.02x the MAX
    # per-slab collapsed count, not the mean: the 1.25 factor is headroom
    # for z-clustering of the collapsed fraction above uniformity
    idx = min(1.0, frac * 1.1 * 1.25) * float(N) ** 3 * 4 / n_chips
    vstream = 3 * half + 3 * spec + idx
    return max(cycle, vstream)


def ooc_storage_dtype(params: Params, n_chips: int = 1,
                      limit: float = None) -> str:
    """Half-transform storage dtype of the out-of-core engine:
    params.ooc_dtype when given, else float32 when the float32 ledger
    fits the device limit, else bfloat16 (half the ledger, at bfloat16
    rounding of the stored transforms)."""
    if params.ooc_dtype:
        return params.ooc_dtype
    limit = device_memory_bytes() if limit is None else limit
    f32 = ooc_device_peak(params, n_chips=n_chips, dtype="float32")
    return "float32" if f32 < limit else "bfloat16"


def ooc_selected(params: Params, n_chips: int = 1,
                 cosmo: Cosmology = None) -> bool:
    """Whether the pipeline will use the out-of-core fmax engine:
    explicit params.ooc, or auto when the monolithic device peak exceeds
    HBM and the configuration is in the engine's coverage."""
    from .fmax_ooc import ooc_supported
    if params.ooc == "on":
        return True
    if params.ooc != "auto" or not ooc_supported(params):
        return False
    if params.ReadProductsFromDumps:
        return False
    # multi-chip: the monolithic mesh-sharded pipeline is preferred
    # while it fits; the kz-sharded ooc engine takes over for grids
    # beyond the chips' COMBINED HBM (e.g. 2048^3 on 8 chips)
    rep = plan(params, n_chips=n_chips, verbose=False, cosmo=cosmo)
    return not rep["fits_hbm"]


def plan(params: Params, n_chips: int = 1, hbm_gb: float = None,
         subboxes: int = None, verbose: bool = True,
         cosmo: Cosmology = None, ooc: bool = False) -> dict:
    """Full memory/decomposition forecast. Returns a report dict; prints
    the reference-style per-array map when verbose (allocations.c:274-311).
    ooc=True models the out-of-core engine's device peak instead of the
    monolithic one.  hbm_gb: the device limit for offline planning
    (default: the detected limit, device_memory_bytes)."""
    import numpy as np
    if cosmo is None:
        cosmo = Cosmology(params)
    from .fmax import STAGED_LPT_THRESHOLD, Smoothing
    from .fragment.subbox import choose_nbox, subbox_geometries
    from .io.catalogs import largest_halo_mass

    N = params.GridSize
    ntot = float(N) ** 3
    sm = Smoothing.build(params, cosmo)
    largest = largest_halo_mass(params, cosmo)
    nfields = {1: 1, 2: 2, 3: 4}[params.lpt_order]
    nseg = len(params.output_z) if params.recompute_displacements else 1
    cells = ntot / n_chips                       # per-chip cells
    field = cells * F4                           # one fp32 N^3/chips field
    khalf = cells * (N // 2 + 1) / N * 2 * F4    # one c64 half-spectrum

    # ---- fmax stage (device), phase-peak model ----
    # phase 1, radius cycle (fmax_loop): kdensity + 6 Hessian + Fmax/Rmax
    # + FFT scratch (one half-spectrum in flight + c2r temporaries)
    loop_phase = dict(kdensity=khalf, hessian=6 * field,
                      fmax_rmax=2 * field, fft_scratch=4 * khalf)
    # phase 2, displacements: staged (N >= STAGED_LPT_THRESHOLD) frees the
    # Hessian after lpt_sources and holds 3 source k-vectors + the growing
    # displacement dict; monolithic holds Hessian + everything at once.
    # RECOMPUTE segments are fetched straight to host (fmax.py staged_vels)
    # so they never stack on device.
    staged = N >= STAGED_LPT_THRESHOLD
    # sparse transfer: compacted-row fetch buffers live on device during
    # the LPT phase (fmax.PendingFetch): idx+Fs [cap], up to nfields row
    # sets [cap,3] float16 in flight, plus the (-F, cell) sort transient
    sparse = params.sparse_transfer
    if sparse is None:
        sparse = True                    # the GPU default
    frac0 = collapsed_fraction(params, cosmo, sm)
    cap = min(1.0, frac0 + 1.0 / 16.0) * cells
    fetch = (cap * (4 + 4) + nfields * cap * 3 * 2) if sparse else 0.0
    displ = 3 * nfields * field
    if staged and sparse:
        # dense stacks are freed as each stack's rows are gathered
        lpt_phase = dict(kdensity=khalf, kvectors=3 * khalf,
                         fmax_rmax=2 * field, displacements=3 * field,
                         fetch_buffers=fetch, sort_scratch=2 * field,
                         fft_scratch=3 * khalf)
    elif staged:
        lpt_phase = dict(kdensity=khalf, kvectors=3 * khalf,
                         fmax_rmax=2 * field, displacements=displ,
                         fft_scratch=3 * khalf)
    else:
        lpt_phase = dict(kdensity=khalf, hessian=6 * field,
                         kvectors=3 * khalf, fmax_rmax=2 * field,
                         displacements=displ, fetch_buffers=fetch,
                         sort_scratch=(2 * field if sparse else 0.0),
                         fft_scratch=3 * khalf)
    loop_total = sum(loop_phase.values())
    lpt_total = sum(lpt_phase.values())
    device_total = max(loop_total, lpt_total)
    device_peak_phase = ("collapse cycle" if loop_total >= lpt_total
                         else "LPT displacements")
    if ooc:
        dt = ooc_storage_dtype(params, n_chips,
                               limit=hbm_gb * GB if hbm_gb else None)
        device_total = ooc_device_peak(params, frac=frac0,
                                       n_chips=n_chips, dtype=dt)
        cyc = ooc_device_peak(params, frac=0.0, n_chips=n_chips, dtype=dt)
        device_peak_phase = ("ooc cycle (u stack + Fmax)"
                             if device_total <= cyc
                             else "ooc v-streams (u_v + spectra + idx)")
        fmax_rows = float(N) ** 3 * (4 if dt == "float32" else 2) / n_chips
        loop_phase = dict(half_transforms=cyc - fmax_rows, fmax=fmax_rows)
        lpt_phase = dict(device_peak=device_total)
        # the breakdown must match the phase the peak came from (the
        # monolithic loop_total/lpt_total comparison below is meaningless
        # here)
        ooc_breakdown = (loop_phase if device_total <= cyc
                         else lpt_phase)

    # ---- fragmentation (host) ----
    frac = frac0
    nstored = frac * ntot
    # sparse products (fmax.SparseProducts): ci 8 + F 4 + vel rows
    sparse_pp = 8 + 4 + 3 * nfields * F4
    # sweep-side gathered copies (fragment/driver.py): Fs + pos + vel rows
    # + group-of-particle + zacc, plus per-segment displacement sets
    sweep_pp = 4 + 4 + 3 * nfields * F4 * nseg + 4 + 4
    # dense grids: loc map + F_grid (per concurrently-swept sub-box)
    grids = 2 * ntot * 4
    host_frag = nstored * (sparse_pp + sweep_pp) + grids
    bytes_pp = host_frag / ntot

    nsub = subboxes or params.subbox_tasks or 1
    nbox = choose_nbox(params, cosmo, largest, nsub)
    geoms = subbox_geometries(params, cosmo, largest, nbox)
    overhead = sum(float(np.prod(g.L)) for g in geoms) / ntot

    # ---- outputs (estimate_file_size analog, fragment.c:964-1065) ----
    npeaks_est = ntot / 6.0 * params.PredPeakFactor
    halo_frac = 0.35                     # good halos per peak, measured
    catalog_bytes = npeaks_est * halo_frac * 56 * len(params.output_z)

    # ---- budgets ----
    hbm = hbm_gb * GB if hbm_gb else device_memory_bytes()
    host_budget = params.MaxMem * MB * max(1, params.subbox_tasks)

    report = dict(
        grid=N, n_chips=n_chips, nsmooth=sm.n, nseg=nseg,
        device_bytes=device_total,
        device_peak_phase=device_peak_phase,
        device_breakdown=(ooc_breakdown if ooc
                          else loop_phase if loop_total >= lpt_total
                          else lpt_phase),
        device_limit=hbm,
        fits_hbm=device_total < hbm,
        est_collapsed_fraction=frac,
        host_fragmentation_bytes=host_frag,
        host_budget_bytes=host_budget,
        bytes_per_particle=bytes_pp,
        fits_host=(host_frag < host_budget
                   and bytes_pp < params.MaxMemPerParticle),
        nbox=nbox, boundary_overhead=overhead,
        est_catalog_bytes=catalog_bytes,
        largest_halo_Msun=largest,
    )
    if verbose:
        print(format_memory_map(report, params))
    return report


def format_memory_map(report: dict, params: Params) -> str:
    """Reference-style per-array memory map (allocations.c:274-311)."""
    lines = [f"RUN PLAN for {report['grid']}^3 on {report['n_chips']} "
             f"chip(s)",
             f"  smoothing radii:            {report['nsmooth']}"
             f"   displacement segments: {report['nseg']}",
             f"  largest expected halo:      "
             f"{report['largest_halo_Msun']:.3g} Msun",
             f"  device memory, peak phase ({report['device_peak_phase']}):"
             f" {report['device_bytes'] / GB:.2f} GB/chip of "
             f"{report['device_limit'] / GB:.1f} GB "
             f"{'(OK)' if report['fits_hbm'] else '(EXCEEDS HBM!)'}"]
    for k, v in report["device_breakdown"].items():
        lines.append(f"     {k:<16s} {v / GB:8.3f} GB")
    lines += [
        f"  est. collapsed fraction:    "
        f"{report['est_collapsed_fraction']:.2f}",
        f"  host fragmentation memory:  "
        f"{report['host_fragmentation_bytes'] / GB:.2f} GB of "
        f"{report['host_budget_bytes'] / GB:.2f} GB budget "
        f"(MaxMem {params.MaxMem} MB x {max(1, params.subbox_tasks)} "
        f"tasks) {'(OK)' if report['fits_host'] else '(EXCEEDS BUDGET!)'}",
        f"     bytes/particle {report['bytes_per_particle']:.0f} "
        f"(MaxMemPerParticle {params.MaxMemPerParticle:.0f})",
        f"  sub-box decomposition:      {report['nbox']}, boundary "
        f"overhead {report['boundary_overhead']:.2f}x",
        f"  est. catalog output size:   "
        f"{report['est_catalog_bytes'] / MB:.1f} MB",
    ]
    return "\n".join(lines)


def enforce_budget(params: Params, n_chips: int = 1, verbose: bool = True,
                   cosmo: Cosmology = None, ooc: bool = False) -> dict:
    """Pre-flight budget check, called from run_pipeline BEFORE any
    allocation (the analog of organize_main_memory's abort,
    allocations.c:196-204,317-324).  Raises MemoryPlanError with the
    per-array map when the predicted device or host footprint exceeds
    MaxMem / MaxMemPerParticle / detected HBM.  ooc: the run will use
    the out-of-core engine, so its bounded ledger is what must fit."""
    import jax
    report = plan(params, n_chips=n_chips, verbose=False, cosmo=cosmo,
                  ooc=ooc)
    on_cpu = jax.default_backend() == "cpu"
    problems = []
    if on_cpu:
        # device arrays live in host RAM: one combined budget
        total = report["device_bytes"] * n_chips \
            + report["host_fragmentation_bytes"]
        if total > report["host_budget_bytes"]:
            problems.append(
                f"combined host footprint {total / GB:.2f} GB exceeds the "
                f"MaxMem budget {report['host_budget_bytes'] / GB:.2f} GB "
                f"(raise MaxMem or subbox_tasks)")
    else:
        if not report["fits_hbm"]:
            problems.append(
                f"device footprint {report['device_bytes'] / GB:.2f} "
                f"GB/chip exceeds HBM {report['device_limit'] / GB:.1f} GB "
                f"(shard with --chips N or reduce GridSize)")
        if report["host_fragmentation_bytes"] > report["host_budget_bytes"]:
            problems.append(
                f"host fragmentation memory "
                f"{report['host_fragmentation_bytes'] / GB:.2f} GB exceeds "
                f"the MaxMem budget "
                f"{report['host_budget_bytes'] / GB:.2f} GB")
    if report["bytes_per_particle"] > params.MaxMemPerParticle:
        problems.append(
            f"required {report['bytes_per_particle']:.0f} bytes/particle "
            f"exceed MaxMemPerParticle {params.MaxMemPerParticle:.0f}")
    if problems:
        raise MemoryPlanError(
            "memory pre-flight failed:\n  - " + "\n  - ".join(problems)
            + "\n" + format_memory_map(report, params))
    if verbose:
        print(f"[plan] memory pre-flight OK: device "
              f"{report['device_bytes'] / GB:.2f} GB/chip, host "
              f"{report['host_fragmentation_bytes'] / GB:.2f} GB, "
              f"{report['bytes_per_particle']:.0f} B/particle")
    return report


def expected_halo_number(params: Params, cosmo: Cosmology,
                         z: float) -> float:
    """Expected halos above MinHaloMass in the box at z: the analytic
    mass function integrated over ln m (Integrand_MF + qags,
    fragment.c:974-996)."""
    from scipy.integrate import quad
    lnm_min = math.log(params.ParticleMass * params.MinHaloMass)
    val, _ = quad(lambda lnm: cosmo.AnalyticMassFunction(math.exp(lnm), z)
                  * math.exp(lnm), lnm_min, 37.0, limit=100)
    return val * params.BoxSize_htrue ** 3


def expected_plc_halo_number(params: Params, cosmo: Cosmology) -> float:
    """Expected halos crossing the past light cone between LastzForPLC and
    StartingzForPLC (compute_Nhalos_in_PLC, fragment.c:922-950): the mass
    function integrated over the cone's comoving volume."""
    from scipy.integrate import quad
    C_KMS = 299792.458
    z1 = max(params.LastzForPLC, 0.0)
    z2 = params.StartingzForPLC
    if z2 <= z1:
        return 0.0
    theta = math.radians(min(params.PLCAperture, 180.0))
    fsky = 0.5 * (1.0 - math.cos(theta))

    def dNdz(z):
        dc = float(cosmo.ComovingDistance(z))
        dvdz = 4.0 * math.pi * C_KMS / float(cosmo.Hubble(z)) * dc * dc
        lnm_min = math.log(params.ParticleMass * params.MinHaloMass)
        nofm, _ = quad(lambda lnm: cosmo.AnalyticMassFunction(
            math.exp(lnm), z) * math.exp(lnm), lnm_min, 37.0, limit=50)
        return dvdz * fsky * nofm

    val, _ = quad(dNdz, z1, z2, limit=40)
    return val


def estimate_file_sizes(params: Params, cosmo: Cosmology,
                        verbose: bool = True) -> dict:
    """ESTIMATED STORAGE REQUIREMENTS report (estimate_file_size,
    fragment.c:964-1065): per-output catalog sizes from the analytic mass
    function, histories (1.4x the z_last catalog), PLC, timeless snapshot."""
    CATALOG_BYTES = 56          # catalog_data: u64 + 10 f32 + 2 i32
    PLC_BYTES = 56              # plc_write_data is the same weight class
    out = dict(catalogs={}, total=0.0)
    lines = ["ESTIMATED STORAGE REQUIREMENTS:"]
    number = 0.0
    for z in params.output_z:
        number = expected_halo_number(params, cosmo, z)
        size = number * CATALOG_BYTES
        out["catalogs"][z] = size
        out["total"] += size
        lines.append(f"  catalog, z={z:6.4f}: ~{int(number)} halos, "
                     f"{size / MB:.1f} Mbyte"
                     + (f" ({size / MB / params.NumFiles:.1f}/file)"
                        if params.NumFiles > 1 else ""))
    hist = number * CATALOG_BYTES * 1.4
    out["histories"] = hist
    out["total"] += hist
    lines.append(f"  histories (order of magnitude): {hist / MB:.1f} Mbyte")
    if params.plc_enabled and params.StartingzForPLC > 0.0:
        nplc = expected_plc_halo_number(params, cosmo)
        size = nplc * PLC_BYTES
        out["plc"] = size
        out["total"] += size
        lines.append(f"  past light cone: ~{int(nplc)} halos, "
                     f"{size / MB:.1f} Mbyte")
    if params.WriteTimelessSnapshot:
        ntot = float(params.GridSize) ** 3
        nvel = {1: 3, 2: 6, 3: 12}[params.lpt_order]
        nblo = {1: 4, 2: 5, 3: 7}[params.lpt_order]
        size = 268.0 + ntot * 4 + 6.0 \
            + (nvel + 2) * (ntot * 4 + 6.0) + nblo * 40 + 6.0
        out["snapshot"] = size
        out["total"] += size
        lines.append(f"  timeless snapshot: {size / MB:.1f} Mbyte")
    lines.append(f"  total storage: {out['total'] / MB:.1f} Mbyte")
    if verbose:
        print("\n".join(lines))
    return out


def sweep(params: Params, hbm_gb: float = None, max_chips: int = 256,
          verbose: bool = True) -> list:
    """Chip-count sweep: the analog of the reference planner's nodes x
    tasks-per-node scan (run_planner.c:44-140) — report, for each power-of-
    two chip count, whether the fmax stage fits HBM and what the host-side
    fragmentation needs."""
    cosmo = Cosmology(params)
    rows = []
    c = 1
    while c <= max_chips:
        r = plan(params, n_chips=c, hbm_gb=hbm_gb, verbose=False,
                 cosmo=cosmo)
        rows.append(dict(chips=c, device_gb=r["device_bytes"] / GB,
                         fits=r["fits_hbm"],
                         limit_gb=r["device_limit"] / GB,
                         host_gb=r["host_fragmentation_bytes"] / GB))
        c *= 2
    if verbose:
        limit = rows[0]["limit_gb"] if rows else 0.0
        print(f"CHIP SWEEP for {params.GridSize}^3 "
              f"({limit:.0f} GB device memory/chip)")
        print(f"  {'chips':>6s} {'device GB/chip':>15s} {'fits':>5s} "
              f"{'host frag GB':>13s}")
        for r in rows:
            print(f"  {r['chips']:>6d} {r['device_gb']:>15.2f} "
                  f"{'yes' if r['fits'] else 'NO':>5s} "
                  f"{r['host_gb']:>13.2f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parameter_file")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory per chip for offline planning "
                    "(default: the detected limit)")
    ap.add_argument("--subboxes", type=int, default=None)
    ap.add_argument("--grid", type=int, default=None)
    ap.add_argument("--norad", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="scan chip counts (run_planner.c:44-140 analog)")
    args = ap.parse_args(argv)
    overrides = {"norad": True} if args.norad else {}
    params = read_parameter_file(args.parameter_file, **overrides)
    if args.grid:
        params.GridSize = args.grid
    if args.sweep:
        sweep(params, hbm_gb=args.hbm_gb)
    else:
        plan(params, n_chips=args.chips, hbm_gb=args.hbm_gb,
             subboxes=args.subboxes)


if __name__ == "__main__":
    main()
