#!/usr/bin/env python
"""Exchange pack-time scaling vs mocked host count (VERDICT r3 item 8).

The packed sparse all_to_all (parallel/exchange.py) tests every shard
cell against every destination host's region union — O(nhosts x cells),
like the reference's per-destination hypercube passes
(distribute.c:280-307).  This experiment measures the actual growth on a
16-device CPU mesh: run with

    XLA_FLAGS=--xla_force_host_platform_device_count=16 \
        python scripts/exp_exchange_scaling.py [--grid 64]

Prints one JSON line {"grid": N, "rows": [{"nhosts": H,
"pack_s": t, "delivered": n}, ...]} and checks the 16-host union against
the needed-particle set.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--hosts", type=int, nargs="*", default=[2, 4, 8, 16])
    args = ap.parse_args()

    ndev = len(jax.devices())
    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fragment.subbox import (choose_nbox,
                                               subbox_geometries)
    from pinocchio_jax.io.catalogs import largest_halo_mass
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    from pinocchio_jax.parallel.exchange import exchange_products

    p = read_parameter_file(HMF_VALIDATION, norad=True, plc_enabled=False)
    p.GridSize = args.grid
    cosmo = Cosmology(p)
    mesh = pfft.make_mesh(ndev)
    res = run_fmax_distributed(p, cosmo, mesh, verbose=False)
    F = np.asarray(res.products.Fmax)
    needed = np.flatnonzero(F.ravel() >= p.Flast)

    largest = largest_halo_mass(p, cosmo)
    rows = []
    for nh in args.hosts:
        if nh > ndev:
            continue
        geoms = subbox_geometries(p, cosmo, largest,
                                  choose_nbox(p, cosmo, largest, nh))
        # warm the program cache, then time the steady state
        exchange_products(p, res, mesh, geoms, nh, f16=False)
        t0 = time.perf_counter()
        out = exchange_products(p, res, mesh, geoms, nh, f16=False)
        dt = time.perf_counter() - t0
        delivered = int(sum(len(s.ci) for s in out.values()))
        rows.append(dict(nhosts=nh, pack_s=round(dt, 3),
                         delivered=delivered))
        got = np.unique(np.concatenate([out[h].ci for h in out]))
        assert np.array_equal(got, needed), f"union mismatch at {nh} hosts"
    print("RESULT " + json.dumps(dict(grid=args.grid, ndev=ndev,
                                      rows=rows)), flush=True)


if __name__ == "__main__":
    main()
