#!/usr/bin/env python
"""Benchmark: end-to-end pipeline wall-clock + collapse throughput + HMF
residual, vs the (extrapolated) MPI reference at equal host count.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The headline metric is the END-TO-END wall-clock (IC + collapse cycle +
LPT + fragmentation + catalog/mf/histories writing) at the chosen grid,
resolution-matched to the reference's HMF_Validation config (1 Mpc/h
cells). vs_baseline = extrapolated reference wall-clock / engine
wall-clock at EQUAL HOST COUNT (this host's physical cores, ideal MPI
scaling — generous to the reference).

Why extrapolated: the MPI reference cannot be rebuilt on this image — it
needs FFTW3(+MPI), PFFT, GSL and mpicc (src/Makefile:207-224,
INSTALLATION:40-50) and none are installed (verified: no libfftw3*/
libgsl*/libpfft*/fftw3.h/gsl_rng.h/mpicc anywhere on the filesystem, and
package installation is not permitted).  The model instead scales the
reference's own shipped single-task measurement (HMF_Validation/
log_RUN.txt: 14.04 s total at 128^3, of which ~2.8 s is FFT execute +
k-space ops) as
    T_ref(N, ntasks) = [ (T_128 - T_fft) * (N/128)^3
                         + T_fft * (N/128)^3 * log2(N)/log2(128) ]
                       / ntasks
i.e. O(N^3) for collapse/fragmentation/sort phases, O(N^3 log N) for the
FFT share, and perfect strong scaling over the host's cores.

Runs on a GPU only: it fails when JAX finds none, and every result names
the device kind and count.

Usage: python bench.py [--grid N] [--repeat K] [--collapse-only]
                       [--outdir D]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_SOLVES_PER_S = 4.1e6      # implied collapse-kernel rate, 1 CPU task
REF_T128_TOTAL = 14.04        # HMF_Validation/log_RUN.txt total, 1 task
REF_T128_FFT = 2.8            # its FFT execute + k-space + mem share


def reference_wallclock(N: int, ntasks: int) -> float:
    vol = (N / 128.0) ** 3
    logf = math.log2(N) / math.log2(128)
    return ((REF_T128_TOTAL - REF_T128_FFT) * vol
            + REF_T128_FFT * vol * logf) / max(1, ntasks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--collapse-only", action="store_true",
                    help="skip fragmentation/outputs (round-1 metric)")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--passes", type=int, default=None,
                    help="max end-to-end passes (default 4 below 512^3, "
                         "else 2; early-stop when two agree within 10%)")
    ap.add_argument("--outdir", default=None,
                    help="where outputs are written (default: temp dir)")
    args = ap.parse_args()

    from pinocchio_jax.backend import setup
    setup()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fmax import Smoothing, fmax_loop
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    from pinocchio_jax.ops import collapse

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX runs on "
                         f"{dev.platform!r}")
    device = f"{len(jax.devices())} x {dev.device_kind}"
    params = read_parameter_file(HMF_VALIDATION, norad=True,
                                 plc_enabled=False)
    params.GridSize = args.grid
    # scale the box with the grid to keep the reference's resolution
    # (128 Mpc/h at 128^3 -> 1 Mpc/h cells)
    params.BoxSize = float(args.grid)

    ncores = os.cpu_count() or 1
    cosmo = Cosmology(params)
    grid = Grid(N=args.grid, BoxSize=params.BoxSize_htrue)
    sm = Smoothing.build(params, cosmo)
    N = args.grid

    # ---- collapse-phase throughput ----
    def measure_collapse():
        kden = generate_kdensity(grid, cosmo, params.RandomSeed)
        kden.block_until_ready()
        pack = collapse.make_inverse_growth_fit(cosmo)
        radii_grid = jnp.asarray(sm.radii / grid.CellSize, jnp.float32)
        ig_packs = jnp.asarray(np.tile(pack[None, :], (sm.n, 1)))

        def collapse_phase(kd):
            return jax.block_until_ready(
                fmax_loop(kd, radii_grid, ig_packs, N, sm.n))

        collapse_phase(kden)      # compile
        best = 1e30
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            collapse_phase(kden)
            best = min(best, time.perf_counter() - t0)
        return N ** 3 * sm.n / best, best

    if args.collapse_only:
        rate, best = measure_collapse()
        print(json.dumps({
            "metric": f"Fmax particle-radius solves/s/chip ({N}^3 x "
                      f"{sm.n} radii, collapse phase {best:.3f}s, "
                      f"{device})",
            "value": round(rate / 1e6, 2),
            "unit": "Msolves/s",
            "vs_baseline": round(rate / REF_SOLVES_PER_S, 2)}))
        return

    # ---- end-to-end run with outputs + HMF residual ----
    import tempfile
    from pinocchio_jax.run import run_pipeline
    outdir = args.outdir or tempfile.mkdtemp(prefix="bench_")
    os.makedirs(outdir, exist_ok=True)
    params.subbox_tasks = ncores if N >= 256 else 1
    # MaxMem in the reference param file is a PER-MPI-TASK budget tuned
    # for its cluster (3600 MB); the equal-host comparison lets both
    # codes use this host's physical RAM
    params.MaxMem = int(os.sysconf("SC_PAGE_SIZE")
                        * os.sysconf("SC_PHYS_PAGES") * 0.85 / 1024 ** 2
                        / max(1, params.subbox_tasks))
    # several passes: the first may still compile programs (the
    # persistent cache makes later processes skip this) and host
    # wall-clock jitters between passes.  Run up to `max_passes`,
    # stopping early once two passes agree within 10% — then the best
    # is a steady state, not a lucky draw.
    max_passes = args.passes or (4 if N < 512 else 2)
    engine_s, phases, pass_times = 1e30, {}, []
    for ipass in range(max_passes):
        t0 = time.perf_counter()
        pipe = run_pipeline(params, outdir=outdir, verbose=False,
                            write_outputs=True)
        t = time.perf_counter() - t0
        pass_times.append(round(t, 2))
        if t < engine_s:
            engine_s = t
            phases = {k: round(v, 2) for k, v in sorted(
                pipe["timings"].items(), key=lambda kv: -kv[1])
                if v >= 0.5 and k != "total"}
        del pipe                  # release device buffers between passes
        import gc
        gc.collect()
        if ipass >= 1 and sorted(pass_times)[1] < 1.1 * engine_s:
            break                 # two passes agree: steady state

    from pinocchio_jax.planner import ooc_selected
    if ooc_selected(params, cosmo=cosmo):
        # grids beyond the monolithic engine's device memory (ooc path):
        # the dense collapse-phase microbench cannot allocate; the e2e
        # number above is the story
        rate = 0.0
    else:
        rate, _ = measure_collapse()

    # HMF average residual vs the chosen analytic fit (the reference's
    # own validation metric: mean |n/n_fit - 1| over populated bins,
    # HMF_Validation/VALIDATION_log.txt -> 2.06e-01 for its shipped run)
    mf = np.loadtxt(os.path.join(
        outdir, f"pinocchio.{params.output_z[-1]:6.4f}."
                f"{params.RunFlag}.mf.out"))
    sel = mf[:, 4] > 100          # populated bins
    hmf_resid = float(np.abs(mf[sel, 1] / mf[sel, 5] - 1.0).mean())

    ref_s = reference_wallclock(N, ncores)
    result = {
        "metric": f"end-to-end wall-clock {N}^3 (IC+collapse+LPT+"
                  f"fragmentation+outputs), {device} + {ncores} host "
                  f"cores",
        "value": round(engine_s, 2),
        "unit": "s",
        "vs_baseline": round(ref_s / engine_s, 2),
        "reference_s_extrapolated": round(ref_s, 1),
        "reference_model": "shipped HMF_Validation 128^3 single-task "
                           "14.04s scaled O(N^3 (log N for FFT share)) / "
                           f"{ncores} cores ideal MPI scaling; the MPI "
                           "reference is not buildable on this image "
                           "(FFTW3/PFFT/GSL/mpicc absent)",
        "collapse_Msolves_per_s": round(rate / 1e6, 2),
        "collapse_vs_ref_kernel": round(rate / REF_SOLVES_PER_S, 2),
        "hmf_avg_residual_vs_fit": round(hmf_resid, 4),
        "hmf_reference_residual": 0.206,
        "nsmooth": sm.n,
        "pass_times_s": pass_times,
        "phases_s": phases,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
