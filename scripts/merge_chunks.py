#!/usr/bin/env python
"""Merge a multi-host run's per-host output chunks into the single-file
layout and recompute the derived products each host could not write
alone (mass functions, PLC n(z)).

Multi-host runs (`python -m pinocchio_jax.run ... --hosts N --host-id i`)
write `pinocchio.<z>.<run>.catalog.out.<host>` (and .histories/.plc)
chunks — the collector-scheme file layout of the reference
(write_halos.c:194-225) with one chunk per host.  This tool:

  * concatenates each output's chunks into the canonical single file
    (binary chunks become one multi-record file ReadPinocchio5.py
    parses; ascii chunks are concatenated past the header);
  * recomputes the mass function from the merged catalog
    (`io.catalogs.compute_mf`), which needs the FULL halo population;
  * sums the per-host PLC n(z) histograms into pinocchio.<run>.nz.out.

Usage: python scripts/merge_chunks.py <parameter_file> [--dir D] [--keep]
"""

import argparse
import glob
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def merge_file(path: str, chunks, keep: bool):
    """Concatenate chunks into `path`, aware of each output's binary
    framing so the result is exactly one collector-scheme file
    (write_halos.c:194-225,1035-1103) that ReadPinocchio5.py parses:

      catalog    [NTasksPerFile,itemsize](16B) + per-task blocks
      plc        [itemsize](12B)              + per-task blocks
      histories  [itemsize](12B) + global [Ntrees,Nbranches](16B)
                 + collector blocks — the global counts are re-summed

    Ascii chunks lose their repeated comment headers."""
    import struct
    with open(chunks[0], "rb") as fd:
        ascii_mode = fd.read(1) == b"#"
    histories = ".histories." in os.path.basename(path)
    skip = 12 if ".plc." in os.path.basename(path) else 16
    if histories:
        skip = 28                      # itemsize record + global record
        ntrees = nbranch = 0
        for chunk in chunks:
            with open(chunk, "rb") as fd:
                hdr = fd.read(28)
            t, b = struct.unpack("<ii", hdr[16:24])
            ntrees += t
            nbranch += b
    with open(path, "wb") as out:
        for i, chunk in enumerate(chunks):
            with open(chunk, "rb") as fd:
                data = fd.read()
            if ascii_mode:
                if i > 0:
                    data = re.sub(rb"^(#[^\n]*\n)+", b"", data)
            elif histories:
                if i == 0:
                    out.write(data[:12])
                    out.write(struct.pack("<iiii", 8, ntrees, nbranch, 8))
                data = data[skip:]
            elif i > 0:
                data = data[skip:]     # repeated header record
            out.write(data)
    if not keep:
        for chunk in chunks:
            os.remove(chunk)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paramfile")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--keep", action="store_true",
                    help="keep the per-host chunks")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from pinocchio_jax.config import read_parameter_file
    from pinocchio_jax.cosmology import Cosmology
    from pinocchio_jax.fragment.driver import CatalogSnapshot
    from pinocchio_jax.io import readers
    from pinocchio_jax.io.catalogs import compute_mf, largest_halo_mass

    params = read_parameter_file(args.paramfile)
    cosmo = Cosmology(params)
    largest = largest_halo_mass(params, cosmo)
    merged = []

    # every base output that has .<host> chunks
    pat = re.compile(r"\.out\.(\d+)$")
    bases = {}
    for f in sorted(glob.glob(os.path.join(
            args.dir, f"pinocchio.*{params.RunFlag}*.out.*"))):
        m = pat.search(f)
        if m:
            bases.setdefault(f[:m.start() + 4], []).append(f)
    for base, chunks in sorted(bases.items()):
        merged.append(merge_file(base, sorted(
            chunks, key=lambda s: int(s.rsplit(".", 1)[1])), args.keep))
        print(f"merged {len(chunks)} chunks -> {base}")

    # recompute mass functions from the merged catalogs
    for z in params.output_z:
        cat = os.path.join(args.dir,
                           f"pinocchio.{z:6.4f}.{params.RunFlag}"
                           f".catalog.out")
        if not os.path.exists(cat):
            continue
        rec = readers.read_catalog(cat)
        snap = CatalogSnapshot(z=z, name=rec["name"],
                               mass=rec["n"].astype(np.int32),
                               q=rec["q"], x=rec["x"], v=rec["v"])
        out = compute_mf(params, cosmo, snap, args.dir, largest=largest)
        merged.append(out)
        print(f"recomputed {out} ({len(rec)} halos)")

    # timeless snapshot: assemble per-host npz chunks into the
    # canonical Gadget file (byte-identical to a single-host write)
    from pinocchio_jax.io.snapshot import merge_timeless_chunks
    snap = merge_timeless_chunks(params, args.dir, keep=args.keep)
    if snap:
        merged.append(snap)
        print(f"merged timeless snapshot -> {snap}")

    # n(z) from the merged PLC (each host only saw its own crossings)
    plc_path = os.path.join(args.dir,
                            f"pinocchio.{params.RunFlag}.plc.out")
    if os.path.exists(plc_path) and params.plc_enabled:
        from pinocchio_jax.plc import build_plc_geometry, write_nz
        geom = build_plc_geometry(params, cosmo, verbose=False)
        if geom is not None and geom.enabled:
            rec = readers.read_plc(plc_path)
            z_last = min(params.StartingzForPLC, params.LastzForPLC)
            nz = np.histogram(
                rec["red"], bins=geom.nzbins,
                range=(z_last, z_last + geom.nzbins * geom.delta_z))[0]
            merged.append(write_nz(params, cosmo, geom, nz, args.dir))
            print(f"recomputed n(z) from {len(rec)} PLC rows")
    if not merged:
        print("nothing to merge (no .out.<host> chunks found)")
    return merged


if __name__ == "__main__":
    main()
