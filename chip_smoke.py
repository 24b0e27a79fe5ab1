#!/usr/bin/env python
"""Bring-up check of the validation deployment on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: device, end to end at 512^3,
                                   # Hessian transform, engine parity
    python chip_smoke.py --four    # four GPUs: only the multi-card paths,
                                   # each against one card

Everything runs in this one process through the package (pinocchio_jax).
Every phase checks its result; a failed check or any exception ends the
script with a non-zero exit code and no result line.  The last line of a
passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The phase functions take their sizes as arguments, so the CPU tests run
them at 32^3 (tests/test_chip_smoke.py); main() refuses any device that is
not a GPU.
"""

import argparse
import dataclasses
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the validation deployment at a size its users run (512 Mpc/h, 512^3; the
# planner puts the monolithic device peak near 10.5 GB), and the grid of
# the float64 and engine parity checks
GRID = 512
PARITY_GRID = 256
# the reference's own z=0 HMF residual against the Watson fit (BASELINE.md)
HMF_RESIDUAL_LIMIT = 0.206
# the FFT Hessian against the float64 reference, relative to max |ref|
HESSIAN_TOL = 1e-5
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def validation_params(N: int, **over):
    """The validation deployment (configs/hmf_validation) at N^3 with its
    1 Mpc/h cells: BoxSize = GridSize in Mpc/h."""
    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    p = read_parameter_file(HMF_VALIDATION, norad=True, plc_enabled=False)
    return dataclasses.replace(p, GridSize=N, BoxSize=float(N), **over)


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling inside the
    `with` block, summed from its monitoring events."""

    def __enter__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._event)
        return self

    def __exit__(self, *exc):
        import jax.monitoring
        jax.monitoring.unregister_event_duration_listener(self._event)

    def _event(self, name, secs, **_):
        if name in COMPILE_EVENTS:
            self.seconds += secs


# ---------------------------------------------------------------- device

def phase_device(n_expected: int) -> dict:
    """JAX must run on n_expected GPUs (it falls back to the CPU quietly
    when the CUDA plugin does not load, so this is checked, not assumed).
    Prints the device kind and count, and nvidia-smi's name and power
    limit of each card."""
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX runs on {devs[0].platform!r}, not on a GPU")
    check(len(devs) >= n_expected,
          f"{len(devs)} GPU(s) visible, {n_expected} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=120).stdout
    log(f"[device] {devs[0].device_kind} x {len(devs)}")
    for line in smi.strip().splitlines():
        log(line)
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


# ------------------------------------------------------- Hessian transform

def hessian_reference(kden: np.ndarray, R: float, N: int):
    """Yields the six second derivatives delta(k) k_a k_b / k^2
    exp(-k^2 R^2 / 2) in float64 numpy (k in grid units, 'ider' order),
    independent of the package's transform code."""
    k = 2.0 * np.pi / N * np.fft.fftfreq(N, 1.0 / N)
    kz = 2.0 * np.pi / N * np.arange(N // 2 + 1)
    kv = (k[:, None, None], k[None, :, None], kz[None, None, :])
    k2 = kv[0] ** 2 + kv[1] ** 2 + kv[2] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(k2 > 0.0, np.exp(-0.5 * k2 * R * R) / k2, 0.0)
    base = kden.astype(np.complex128) * w
    for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
        yield np.fft.irfftn(base * (kv[a] * kv[b]), s=(N, N, N),
                             axes=(0, 1, 2))


def phase_hessian(N_parity: int, N_timing: int, R: float = 2.0,
                  repeats: int = 3) -> dict:
    """The six Hessian components of derivatives.second_derivatives (the
    FFT path, cuFFT on the GPU) against the float64 reference at
    N_parity^3; then the median time of the whole collapse cycle
    (fmax_loop, warm, ending in block_until_ready) at N_timing^3."""
    import jax
    import jax.numpy as jnp
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fmax import Smoothing, fmax_loop, inverse_growth_packs
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import generate_kdensity
    from pinocchio_jax.ops import derivatives

    p = validation_params(N_parity)
    cosmo = Cosmology(p)
    grid = Grid(N=N_parity, BoxSize=p.BoxSize_htrue)
    kden = generate_kdensity(grid, cosmo, p.RandomSeed)
    sd = np.asarray(derivatives.second_derivatives(kden, jnp.float32(R),
                                                   N_parity))
    errs = []
    for c, ref in enumerate(hessian_reference(np.asarray(kden), R,
                                              N_parity)):
        errs.append(float(np.abs(sd[c] - ref).max() / np.abs(ref).max()))
    del sd, kden
    log(f"[hessian] {N_parity}^3 R={R}: max|err|/max|ref| per component "
        f"(xx yy zz xy xz yz) vs float64: {errs}")
    check(max(errs) < HESSIAN_TOL,
          f"FFT Hessian off the float64 reference: {max(errs)}")

    p = validation_params(N_timing)
    cosmo = Cosmology(p)
    grid = Grid(N=N_timing, BoxSize=p.BoxSize_htrue)
    sm = Smoothing.build(p, cosmo)
    kden = generate_kdensity(grid, cosmo, p.RandomSeed)
    radii = jnp.asarray(sm.radii / grid.CellSize, jnp.float32)
    packs = jnp.asarray(inverse_growth_packs(cosmo, sm))
    jax.block_until_ready(fmax_loop(kden, radii, packs, N_timing, sm.n))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fmax_loop(kden, radii, packs, N_timing,
                                        sm.n))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    log(f"[hessian] fmax_loop {N_timing}^3 x {sm.n} radii: median {t} s "
        f"of {times}; {N_timing ** 3 * sm.n / t / 1e6} Msolves/s")
    return dict(errors=errs, fmax_loop_s=t, nsmooth=sm.n)


# --------------------------------------------------------- engine parity
# (the checks and their limits: pinocchio_jax/parity.py)

def _ooc_rows(res) -> tuple:
    """(ci, {key: rows}) of an out-of-core run, its streams joined."""
    res.ooc_pending.join()
    sp = res.host_products
    return sp.ci, {k: np.asarray(sp.vel[k]) for k in sp.vel}


def _dense_rows(vel: dict, ci) -> dict:
    """Rows [n, 3] of dense [3, N, N, N] displacement stacks at cells ci."""
    return {k: np.asarray(v).reshape(3, -1)[:, ci].T for k, v in vel.items()}


def _monolithic_on_ooc_field(p, cosmo):
    """run_fmax (the monolithic engine, on the default card) on the
    delta(k) that the out-of-core engine draws: its realization is
    defined plane by plane."""
    import jax
    import jax.numpy as jnp
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.grids import Grid
    from pinocchio_jax.ic import kdensity_plane_fn

    N = p.GridSize
    plane = kdensity_plane_fn(Grid(N=N, BoxSize=p.BoxSize_htrue), cosmo,
                              p.RandomSeed)
    kden = jax.jit(lambda: jax.vmap(plane)(
        jnp.arange(N // 2 + 1, dtype=jnp.int32)).transpose(1, 2, 0))()
    res = run_fmax(p, cosmo, kdensity=kden, verbose=False)
    return np.asarray(res.products.Fmax), res.products.vel


def phase_engines(N: int) -> dict:
    """The out-of-core engine (ooc="on": batched FFTs and z-slab dots)
    against the monolithic engine on the same delta(k) at N^3: Fmax over
    the grid and the streamed displacement rows."""
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fmax_ooc import run_fmax_ooc
    from pinocchio_jax.parity import compare_fields

    p = validation_params(N, ooc="on", sparse_transfer=False)
    cosmo = Cosmology(p)
    t0 = time.perf_counter()
    ooc = run_fmax_ooc(p, cosmo, verbose=False)
    ci, rows = _ooc_rows(ooc)
    t_ooc = time.perf_counter() - t0
    t0 = time.perf_counter()
    F_mono, vel_mono = _monolithic_on_ooc_field(p, cosmo)
    t_mono = time.perf_counter() - t0
    log(f"[engines] {N}^3 cold runs: ooc {t_ooc} s, monolithic {t_mono} s")
    return compare_fields("engines ooc/monolithic", N, F_mono,
                          ooc.products.Fmax, _dense_rows(vel_mono, ci),
                          rows, log=log)


# ------------------------------------------------------------ end to end

def phase_end_to_end(N: int, outdir: str, subbox_tasks: int = None) -> dict:
    """run_pipeline on the validation deployment at N^3, writing every
    output, twice: the first (cold) pass pays compilation, which is
    reported as set-up; the second is the warm wall time.  Checks every
    output file and the z=0 HMF residual against the analytic fit."""
    import jax
    from pinocchio_jax.run import run_pipeline

    ntask = subbox_tasks or os.cpu_count() or 1
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    # MaxMem is a per-task budget: let the tasks share 85% of the host
    p = validation_params(N, subbox_tasks=ntask,
                          MaxMem=int(ram * 0.85 / 1024 ** 2 / ntask))
    walls, compiles = [], []
    for _ in range(2):
        with CompileClock() as clock:
            t0 = time.perf_counter()
            res = run_pipeline(p, outdir=outdir, verbose=False)
            walls.append(time.perf_counter() - t0)
        compiles.append(clock.seconds)
    log(f"[e2e] {N}^3 validation run: warm wall {walls[1]} s; set-up: "
        f"cold pass {walls[0]} s of which {compiles[0]} s compiling "
        f"(warm pass compiling {compiles[1]} s)")
    log(f"[e2e] timings {json.dumps(res['timings'])}")

    rf = p.RunFlag
    want = [f"pinocchio.{rf}.cosmology.out", f"pinocchio.{rf}.FmaxPDF.out",
            f"pinocchio.{rf}.histories.out"]
    for z in p.output_z:
        want += [f"pinocchio.{z:6.4f}.{rf}.catalog.out",
                 f"pinocchio.{z:6.4f}.{rf}.mf.out"]
    paths = [os.path.join(outdir, f) for f in want]
    missing = [f for f, path in zip(want, paths)
               if not os.path.exists(path) or not os.path.getsize(path)]
    check(not missing, f"missing or empty outputs: {missing}")
    mf = np.loadtxt(os.path.join(
        outdir, f"pinocchio.{p.output_z[-1]:6.4f}.{rf}.mf.out"))
    sel = mf[:, 4] > 100                        # populated bins
    resid = float(np.abs(mf[sel, 1] / mf[sel, 5] - 1.0).mean())
    log(f"[e2e] z=0 HMF residual vs the analytic fit: {resid} "
        f"(limit {HMF_RESIDUAL_LIMIT}); {len(want)} outputs written")
    check(resid < HMF_RESIDUAL_LIMIT, f"HMF residual {resid}")

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"[e2e] device peak_bytes_in_use {peak}")
    pf = res["fmax"].pending_fetch
    transfer = pf.log.summary() if pf is not None else None
    log(f"[e2e] device->host product transfer {transfer}")
    return dict(wall_s=walls[1], cold_s=walls[0], compile_s=compiles[0],
                timings=res["timings"], hmf_residual=resid,
                peak_bytes=peak, transfer=transfer)


# ------------------------------------------------------- four-card paths

def phase_four(N_mono: int, N_ooc: int, n: int = 4) -> dict:
    """The multi-card paths against one card: run_fmax_distributed at
    N_mono^3 on the pencil mesh (the default for 4 cards) and on the
    slab mesh, against run_fmax; and the kz-sharded out-of-core ledger
    at N_ooc^3 against the monolithic engine on one card (phase_engines
    ties the one-card out-of-core engine to the same reference)."""
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fmax import run_fmax
    from pinocchio_jax.fmax_ooc import run_fmax_ooc
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    from pinocchio_jax.parity import compare_fields

    out = {}
    p = validation_params(N_mono, sparse_transfer=False)
    cosmo = Cosmology(p)
    t0 = time.perf_counter()
    one = run_fmax(p, cosmo, verbose=False)
    F_one = np.asarray(one.products.Fmax)
    vel_one = {k: np.asarray(v) for k, v in one.products.vel.items()}
    del one
    log(f"[four] one card {N_mono}^3 fmax: {time.perf_counter() - t0} s")
    for name, mesh in (("pencil", pfft.make_pencil_mesh(n)),
                       ("slab", pfft.make_mesh(n))):
        # verbose: the per-radius lines mark the end of the sharded
        # collapse cycle, so a run that stops shows which stage it was in
        log(f"[four] {name} mesh {dict(mesh.shape)} {N_mono}^3: start")
        t0 = time.perf_counter()
        dist = run_fmax_distributed(p, cosmo, mesh, verbose=True)
        F = np.asarray(dist.products.Fmax)
        log(f"[four] {name} mesh {dict(mesh.shape)} {N_mono}^3 fmax: "
            f"{time.perf_counter() - t0} s")
        out[name] = compare_fields(f"four {name}/one", N_mono, F_one, F,
                                   vel_one, dist.products.vel, log=log)
        del dist

    p = validation_params(N_ooc, ooc="on", sparse_transfer=False)
    cosmo = Cosmology(p)
    t0 = time.perf_counter()
    F_mono, vel_mono = _monolithic_on_ooc_field(p, cosmo)
    log(f"[four] one card {N_ooc}^3 fmax: {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    sh = run_fmax_ooc(p, cosmo, verbose=False, mesh=pfft.make_mesh(n))
    ci, rows = _ooc_rows(sh)
    log(f"[four] {n} cards {N_ooc}^3 kz-sharded ooc: "
        f"{time.perf_counter() - t0} s")
    out["ooc"] = compare_fields(
        "four ooc sharded/one", N_ooc, F_mono, sh.products.Fmax,
        _dense_rows(vel_mono, ci), rows, log=log)
    return out


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their "
                    "one-card comparisons")
    ap.add_argument("--watchdog", type=float, default=1100.0,
                    help="seconds after which a run that has not ended "
                    "prints every thread's stack and exits non-zero")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(args.watchdog, exit=True)

    from pinocchio_jax.backend import setup
    setup()
    dev = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(GRID, PARITY_GRID)
    else:
        outdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phase_end_to_end(GRID, outdir)
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
        phase_hessian(PARITY_GRID, GRID)
        phase_engines(PARITY_GRID)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
