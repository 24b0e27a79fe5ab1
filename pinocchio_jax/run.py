"""End-to-end pipeline driver: parameter file -> catalogs.

Equivalent of the reference main() standard run (pinocchio.c:220-248):
  initialization -> fmax (collapse times + displacements) -> fragmentation
  -> catalogs / mass functions / histories.

Usage:
    python -m pinocchio_jax.run <parameter_file> [--norad] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import os
import time

from .config import Params, read_parameter_file
from .cosmology import Cosmology


def run_pipeline(params: Params, outdir: str = ".", verbose: bool = True,
                 write_outputs: bool = True, chips: int = None,
                 enforce_memory: bool = True, hosts=None,
                 decomp: str = "auto"):
    """hosts=(host_id, nhosts): multi-host mode (parallel/multihost) —
    this process sweeps its share of the sub-boxes from its own chips'
    shards and writes its catalogs as .out.<host> chunks."""
    from .fmax import run_fmax, fmax_pdf
    from .fragment.driver import run_fragmentation
    from .io import catalogs as io_cat
    from .io import dumps as io_dumps
    import numpy as np

    t_total = time.perf_counter()
    timings = {}

    if hosts and hosts[1] > 1 and write_outputs:
        # remove this host's leftover .part<h>.npz reduction files from
        # a crashed earlier run NOW (hosts are barrier-synced seconds
        # ago by initialize_cluster; parts are only written at run end,
        # so no live part can exist yet) — stale ones would be silently
        # summed into this run's mf/nz reductions
        io_cat.clear_stale_parts(outdir, hosts[0])

    if verbose:
        greetings(params)
    t0 = time.perf_counter()
    cosmo = Cosmology(params)
    timings["init"] = time.perf_counter() - t0
    if verbose:
        print(f"[init] cosmology ready in {timings['init']:.2f}s "
              f"(sigma8={params.Sigma8:.4f})")
    if write_outputs:
        cosmo.write_cosmology_file(outdir)

    # out-of-core engine selection: explicit params.ooc, or auto when
    # the monolithic device footprint exceeds HBM (the reference runs
    # any N^3 on bounded memory, allocations.c:37-251 — fmax_ooc.py is
    # that contract here)
    from .planner import ooc_selected
    use_ooc = ooc_selected(params, n_chips=chips or 1, cosmo=cosmo)
    if verbose and use_ooc:
        print("[fmax] out-of-core engine selected "
              "(bounded half-transform working set)")

    if enforce_memory:
        # pre-flight memory budget BEFORE any grid allocation: abort with
        # the per-array map when MaxMem / MaxMemPerParticle / HBM are
        # exceeded (allocations.c:196-204,317-324 analog)
        t0 = time.perf_counter()
        from .planner import enforce_budget, estimate_file_sizes
        enforce_budget(params, n_chips=chips or 1, verbose=verbose,
                       cosmo=cosmo, ooc=use_ooc)
        if verbose and write_outputs:
            estimate_file_sizes(params, cosmo)
        timings["budget"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    from .plc import build_plc_geometry, write_plc_catalog, write_nz
    plc_geom = build_plc_geometry(params, cosmo, verbose=verbose)
    timings["plc_geom"] = time.perf_counter() - t0

    # per-radius effective growth scales for scale-dependent cosmologies
    scaledep_gm = None
    if getattr(cosmo, "scale_dep", False):
        from .fmax import Smoothing
        from .scaledep import set_scaledep_gm
        t0 = time.perf_counter()
        scaledep_gm = set_scaledep_gm(
            params, cosmo, Smoothing.build(params, cosmo),
            io_cat.largest_halo_mass(params, cosmo), verbose=verbose)
        timings["scaledep"] = time.perf_counter() - t0

    if params.ReadProductsFromDumps:
        # skip GenIC + fmax entirely (pinocchio.c:220-236)
        fmax_res = io_dumps.read_dumps(params, outdir)
        if verbose:
            print("[fmax] products read from dumps")
    elif chips and chips > 1 and use_ooc:
        # grids beyond the chips' COMBINED HBM: the ooc engine with its
        # ledger kz-sharded over a 1-D mesh (every chip holds 1/chips of
        # the stacks/spectra/Fmax; the slab matmuls partition via GSPMD)
        from .fmax_ooc import run_fmax_ooc
        from .parallel import pfft
        mesh = pfft.make_mesh(chips)
        if verbose:
            print(f"[fmax] ooc ledger sharded over {chips} chips")
        fmax_res = run_fmax_ooc(params, cosmo, scaledep_gm=scaledep_gm,
                                verbose=verbose, mesh=mesh)
    elif chips and chips > 1:
        # mesh-sharded device pipeline: explicit --decomp, or auto (slab
        # for prime counts, else pencil — the set_fft_decomposition
        # choice, initialization.c:1205-1379; volumes is the 3-D
        # fall-through for counts beyond pencil capacity)
        from .parallel import pfft
        from .parallel.driver import run_fmax_distributed
        if decomp == "slab":
            mesh = pfft.make_mesh(chips)
        elif decomp == "pencil":
            mesh = pfft.make_pencil_mesh(chips)
        elif decomp == "volumes":
            mesh = pfft.make_volume_mesh(chips)
        else:
            mesh = (pfft.make_pencil_mesh(chips) if chips >= 4
                    and chips % 2 == 0 else pfft.make_mesh(chips))
        if verbose:
            print(f"[fmax] sharded over mesh {dict(mesh.shape)}")
        fmax_res = run_fmax_distributed(params, cosmo, mesh,
                                        scaledep_gm=scaledep_gm,
                                        verbose=verbose)
    elif use_ooc:
        from .fmax_ooc import run_fmax_ooc
        fmax_res = run_fmax_ooc(params, cosmo, scaledep_gm=scaledep_gm,
                                verbose=verbose)
    else:
        fmax_res = run_fmax(params, cosmo, scaledep_gm=scaledep_gm,
                            verbose=verbose)
    timings.update({"fmax_" + k: v for k, v in fmax_res.timings.items()})

    host_id, nhosts = hosts if hosts else (0, 1)
    dump_wanted = (params.DumpProducts and write_outputs
                   and not params.ReadProductsFromDumps)
    # the ooc engine's displacement rows are still streaming in the
    # background here: dump AFTER fragmentation (the rows have landed by
    # then — the sweeps gate on them) instead of blocking the overlap
    dump_deferred = getattr(fmax_res, "ooc_pending", None) is not None
    if dump_wanted and not dump_deferred:
        io_dumps.dump_products(params, fmax_res, outdir,
                               hosts=(host_id, nhosts))
    t_frag = time.perf_counter()
    if params.subbox_tasks > 1 or nhosts > 1:
        from .fragment.subbox import choose_nbox, run_fragmentation_multibox
        largest = io_cat.largest_halo_mass(params, cosmo)
        ntasks = max(params.subbox_tasks, nhosts)
        nbox = choose_nbox(params, cosmo, largest, ntasks)
        frag_res = run_fragmentation_multibox(
            params, cosmo, fmax_res, nbox, plc_geom=plc_geom,
            scaledep_gm=scaledep_gm, largest_mass=largest,
            host_slice=(host_id, nhosts) if nhosts > 1 else None,
            verbose=verbose)
    else:
        frag_res = run_fragmentation(params, cosmo, fmax_res,
                                     plc_geom=plc_geom,
                                     scaledep_gm=scaledep_gm,
                                     verbose=verbose)
    timings.update({"frag_" + k: v for k, v in frag_res.timings.items()})
    timings["frag_wall"] = time.perf_counter() - t_frag
    if getattr(fmax_res, "ooc_pending", None) is not None:
        # the ooc engine's source/fold/stream phases ran on a background
        # thread, overlapped with fragmentation's selection+sort (the
        # sweeps gate on the stream watermark): join it now to surface
        # errors and the final sources/lpt timings
        fmax_res.ooc_pending.join()
        timings.update({"fmax_" + k: v
                        for k, v in fmax_res.timings.items()})
        if dump_wanted:
            t0 = time.perf_counter()
            io_dumps.dump_products(params, fmax_res, outdir,
                                   hosts=(host_id, nhosts))
            timings["dump"] = time.perf_counter() - t0
    if verbose and frag_res.best_pred_peak_factor:
        # fragment.c:477 advice line
        print(f"  the PredPeakFactor parameter could have been "
              f"{frag_res.best_pred_peak_factor:5.2f} in place of "
              f"{params.PredPeakFactor:5.2f}")

    written = []
    if write_outputs:
        # written AFTER fragmentation on purpose: the PDF's histogram
        # transfer is the first full device sync after the LPT stage, and
        # doing it here lets the overlapped product transfers ride behind
        # the sweep instead of serializing before it
        t0 = time.perf_counter()
        if fmax_res.products.Fmax is not None \
                or fmax_res.pdf_hist is not None:
            # absent after a sparse-dump restart (the PDF was already
            # written by the dumping run); the ooc engine precomputes
            # the histogram during needed-prep (no device revisit)
            fmax_pdf(fmax_res.products.Fmax,
                     os.path.join(outdir,
                                  f"pinocchio.{params.RunFlag}"
                                  f".FmaxPDF.out"),
                     hist=fmax_res.pdf_hist)
        timings["fmax_pdf"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        def tick(key):
            now = time.perf_counter()
            timings[key] = timings.get(key, 0.0) + now - tick.last
            tick.last = now
        tick.last = t0

        largest = io_cat.largest_halo_mass(params, cosmo)
        tick("io_largest")

        # multi-host: write into a per-host staging directory so hosts
        # sharing one filesystem never race on the canonical path, then
        # surface each file as an .out.<host> chunk of one logical
        # multi-file output (the collector scheme, write_halos.c:194-225)
        io_dir = outdir
        if nhosts > 1:
            io_dir = os.path.join(outdir, f".host{host_id}")
            os.makedirs(io_dir, exist_ok=True)

        def _host_chunk(path):
            if nhosts > 1:
                chunk = os.path.join(outdir,
                                     f"{os.path.basename(path)}.{host_id}")
                os.replace(path, chunk)
                return chunk
            return path

        # per-snapshot catalogs + mass functions are independent files:
        # write them concurrently (the native ascii formatter releases
        # the GIL; the reference serializes per task, write_halos.c:227)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=4) as _io_ex:
            cat_futs = [_io_ex.submit(io_cat.write_catalog, params, snap,
                                      io_dir)
                        for snap in frag_res.catalogs]
            # multi-host: each host's bin histograms reduce through part
            # files; the last host to land writes the final mf.out (the
            # collector-task reduce, write_halos.c:95-100)
            mf_futs = [_io_ex.submit(
                io_cat.compute_mf, params, cosmo, snap, outdir,
                largest=largest,
                hosts=(host_id, nhosts) if nhosts > 1 else None)
                for snap in frag_res.catalogs]
            for fut in cat_futs:
                written.append(_host_chunk(fut.result()))
            tick("io_catalog")
            for fut in mf_futs:
                p = fut.result()
                if p is not None:
                    written.append(p)
            tick("io_mf")
        if not params.DoNotWriteHistories:
            written.append(_host_chunk(io_cat.write_histories(
                params, frag_res.groups, io_dir)))
            tick("io_histories")
        if frag_res.plc is not None and not params.DoNotWriteCatalogs:
            written.append(_host_chunk(write_plc_catalog(
                params, plc_geom,
                dict(name=frag_res.plc.name, z=frag_res.plc.z,
                     mass=frag_res.plc.mass, x=frag_res.plc.x,
                     v=frag_res.plc.v), io_dir)))
            if nhosts == 1:
                written.append(write_nz(params, cosmo, plc_geom,
                                        frag_res.plc.nz, outdir))
            else:
                # n(z) histogram reduces across hosts like the mf bins
                nz_final = os.path.join(
                    outdir, f"pinocchio.{params.RunFlag}.nz.out")
                merged = io_cat.reduce_parts(nz_final, host_id, nhosts,
                                             dict(nz=frag_res.plc.nz))
                if merged is not None:
                    written.append(write_nz(params, cosmo, plc_geom,
                                            merged["nz"], outdir))
            tick("io_plc")
        if params.WriteTimelessSnapshot:
            if nhosts > 1:
                # each host writes its chips' dense shards + its
                # sub-boxes' per-particle products as an npz chunk;
                # scripts/merge_chunks.py assembles the canonical
                # Gadget file (the collector gather of
                # write_snapshot.c:400-506 via the shared filesystem)
                from .io.snapshot import write_timeless_chunk
                written.append(write_timeless_chunk(
                    params, fmax_res, frag_res, outdir, host_id=host_id))
                tick("io_snapshot")
            else:
                from .io.snapshot import write_timeless_snapshot
                written.append(write_timeless_snapshot(params, fmax_res,
                                                       frag_res, outdir))
                tick("io_snapshot")
        if nhosts > 1:
            try:
                os.rmdir(io_dir)
            except OSError:
                pass
        timings["io"] = time.perf_counter() - t0

    timings["total"] = time.perf_counter() - t_total
    if verbose:
        write_cputimes(timings)
    return dict(cosmo=cosmo, fmax=fmax_res, frag=frag_res,
                timings=timings, files=written)


def greetings(params: Params):
    """Run banner with the active feature set, the analog of the
    reference's compile-option greeting (greetings, initialization.c:2030;
    the ~25 -D directives are runtime switches here)."""
    import jax
    feats = [f"{params.lpt_order}LPT", f"ELL_{params.ell_model.upper()}"]
    if params.norad:
        feats.append("NORADIATION")
    for flag, name in ((params.FixedIC, "FixedIC"),
                       (params.PairedIC, "PairedIC"),
                       (params.recompute_displacements,
                        "RECOMPUTE_DISPLACEMENTS"),
                       (params.WriteTimelessSnapshot, "SNAPSHOT"),
                       (params.use_sim_params, "USE_SIMULATION_PARAMS")):
        if flag:
            feats.append(name)
    if params.FileWithInputSpectrum == "CAMBTable":
        feats.append("READ_PK_TABLE+SCALE_DEPENDENT")
    if params.mod_grav_fr:
        feats.append("MOD_GRAV_FR")
    print("*" * 64)
    print("pinocchio-jax: PINOCCHIO V5.1 in JAX")
    print(f"  run {params.RunFlag}: {params.GridSize}^3 grid, "
          f"{params.BoxSize:g} Mpc{'/h' if params.BoxInH100 else ''} box")
    print(f"  features: {' '.join(feats)}")
    print(f"  backend: {jax.default_backend()} "
          f"({len(jax.devices())} device(s))")
    print("*" * 64)


def write_cputimes(t: dict, fd=None):
    """Hierarchical wall-clock report at exit, the analog of the
    reference's cputime block (write_cputimes, pinocchio.c:266-292)."""
    import sys
    fd = fd or sys.stdout
    total = t.get("total", 0.0) or 1e-30

    def line(label, key, depth=0):
        if key not in t:
            return
        v = t[key]
        fd.write(f"{'  ' * depth}{label:<28s}{v:10.2f} s"
                 f"  ({100.0 * v / total:5.1f}%)\n")

    fd.write("\nCPU TIMES\n")
    line("total", "total")
    line("initialization", "init", 1)
    line("scale-dependent growth", "scaledep", 1)
    fmax_sum = sum(v for k, v in t.items() if k.startswith("fmax_"))
    if fmax_sum:
        fd.write(f"  {'fmax':<26s}{fmax_sum:10.2f} s"
                 f"  ({100.0 * fmax_sum / total:5.1f}%)\n")
    line("density in k-space", "fmax_dens", 2)
    line("collapse cycle (FFTs+ell)", "fmax_fmax_loop", 2)
    line("LPT displacements", "fmax_lpt", 2)
    frag_sum = t.get("frag_total", 0.0)
    if frag_sum:
        fd.write(f"  {'fragmentation':<26s}{frag_sum:10.2f} s"
                 f"  ({100.0 * frag_sum / total:5.1f}%)\n")
    line("transfer+sort", "frag_sort", 2)
    line("peak counting", "frag_peaks", 2)
    line("group sweep (+PLC)", "frag_sweep", 2)
    line("I/O", "io", 1)
    line("catalogs", "io_catalog", 2)
    line("mass functions", "io_mf", 2)
    line("histories", "io_histories", 2)
    line("PLC", "io_plc", 2)
    line("snapshot", "io_snapshot", 2)


def run_special_mode(params: Params, mode: int, outdir: str = ".",
                     verbose: bool = True):
    """Special run modes (pinocchio.c argv[2]):
    2 = write the linear density as a snapshot; 3 = write LPT initial
    conditions as a Gadget snapshot."""
    from .fmax import run_fmax
    from .io.snapshot import write_density_snapshot, write_lpt_snapshot
    from .ops.derivatives import density_field
    import numpy as np

    cosmo = Cosmology(params)
    if mode == 1:
        # write the collapse-time table only (pinocchio.c:100-133)
        from .fmax import Smoothing
        from .ops import tabulated
        sm = Smoothing.build(params, cosmo)
        model = "sng" if params.ell_model == "sng" else "classic"
        ct = tabulated.build_ct_tables_all(cosmo, sm, model=model)
        path = params.CTtableFile if params.CTtableFile not in ("none", "") \
            else os.path.join(outdir,
                              f"pinocchio.{params.RunFlag}.CTtable.out")
        tabulated.write_ct_table_file(path, params, sm, ct["tables"])
        if verbose:
            print(f"collapse-time table written to {path}")
        return path
    if mode == 2:
        from .grids import Grid
        from .ic import generate_kdensity
        grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
        kden = generate_kdensity(grid, cosmo, params.RandomSeed,
                                 fixed=params.FixedIC,
                                 paired=params.PairedIC)
        dens = np.asarray(density_field(kden, params.GridSize))
        return write_density_snapshot(params, dens, outdir)
    if mode == 3:
        fmax_res = run_fmax(params, cosmo, verbose=verbose,
                            keep_dense_products=True)
        return write_lpt_snapshot(params, cosmo, fmax_res, outdir)
    raise ValueError(f"unknown special mode {mode}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parameter_file")
    ap.add_argument("mode", nargs="?", type=int, default=None,
                    help="special mode: 2=linear density snapshot, "
                    "3=LPT IC snapshot (pinocchio.c argv[2])")
    ap.add_argument("--norad", action="store_true",
                    help="no radiation in the background (reference "
                    "-DNORADIATION)")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--grid", type=int, default=None,
                    help="override GridSize")
    ap.add_argument("--platform", default=None,
                    help="jax platform (gpu / cpu; default: JAX's choice)")
    ap.add_argument("--subboxes", type=int, default=None,
                    help="number of fragmentation sub-domains")
    ap.add_argument("--sparse", dest="sparse", action="store_true",
                    default=None,
                    help="force needed-particle compaction of the "
                    "device->host product transfer (default: the device "
                    "policy, on for GPUs)")
    ap.add_argument("--no-sparse", dest="sparse", action="store_false")
    ap.add_argument("--chips", type=int, default=None,
                    help="shard the fmax phase over this many devices "
                    "(pencil mesh when the count factors)")
    ap.add_argument("--decomp", default="auto",
                    choices=["auto", "slab", "pencil", "volumes"],
                    help="FFT domain decomposition for --chips "
                    "(set_fft_decomposition analog; auto = slab for "
                    "prime counts, else pencil)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="number of processes in a multi-host run "
                    "(jax.distributed bring-up; launch one process per "
                    "host with matching --host-id)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's id in [0, hosts)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port for "
                    "jax.distributed.initialize")
    args = ap.parse_args(argv)

    # platform config FIRST (pure jax.config updates, no device use):
    # initialize_cluster touches the backend, which would otherwise lock
    # in the default platform before --platform cpu could take effect
    from .backend import setup
    setup(platform=args.platform)

    hosts = None
    if args.hosts and args.hosts > 1:
        # must run BEFORE any backend/device use (MPI_Init analog)
        from .parallel.multihost import initialize_cluster
        hosts = initialize_cluster(args.hosts, args.coordinator,
                                   args.host_id)

    overrides = {}
    if args.norad:
        overrides["norad"] = True
    params = read_parameter_file(args.parameter_file, **overrides)
    if args.grid:
        params.GridSize = args.grid
    if args.subboxes:
        params.subbox_tasks = args.subboxes
    if args.sparse is not None:
        params.sparse_transfer = args.sparse
    os.makedirs(args.outdir, exist_ok=True)
    if args.mode is not None:
        run_special_mode(params, args.mode, outdir=args.outdir)
    else:
        run_pipeline(params, outdir=args.outdir, chips=args.chips,
                     hosts=hosts, decomp=args.decomp)


if __name__ == "__main__":
    main()
