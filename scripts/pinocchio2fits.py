#!/usr/bin/env python
"""Convert pinocchio-jax (or reference) outputs to FITS and validate.

Analog of the reference's scripts/Pinocchio2fits.py + ValidateFits.py:
converts catalog / histories / plc files (ascii or fortran-unformatted
binary) to FITS BINTABLE files with the run parameters in the header,
then reads the FITS back and checks every column bit-for-bit against the
original arrays.

Usage:
    python scripts/pinocchio2fits.py pinocchio.0.0000.run.catalog.out \
        [more files ...] [--paramfile parameter_file] [--no-validate]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinocchio_jax.io import fits as pfits          # noqa: E402
from pinocchio_jax.io import readers                # noqa: E402


def convert_plc_to_fits(path, params=None, outdir=None):
    rec = readers.read_plc(path)
    extra = [("NHALOS", len(rec), "Number of halos on the light cone")]
    out = pfits._fits_path(path, outdir)
    return pfits.write_fits(out, [("PLC", rec, extra)],
                            primary_cards=[("CODE", "pinocchio-jax", "")])


def validate(fits_path, original_path):
    """Read the FITS back and compare against the source file column by
    column (ValidateFits.py analog)."""
    hdus = pfits.read_fits(fits_path)
    name, hdr, rec = hdus[0]
    if "catalog" in original_path:
        orig = readers.read_catalog(original_path)
    elif "plc" in original_path:
        orig = readers.read_plc(original_path)
    elif "histories" in original_path:
        _, trees = readers.read_histories(original_path)
        orig = np.concatenate(trees)
    else:
        raise ValueError(f"unrecognized product: {original_path}")
    if len(rec) != len(orig):
        return False, f"row count {len(rec)} != {len(orig)}"
    for col in orig.dtype.names:
        # FITS data is big-endian: compare in native order, bit-exact
        a = np.ascontiguousarray(rec[col]).astype(
            np.dtype(rec[col].dtype.base.str).newbyteorder("="))
        b = np.ascontiguousarray(orig[col]).astype(
            np.dtype(orig[col].dtype.base.str).newbyteorder("="))
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            return False, f"column {col} differs"
    return True, f"{len(rec)} rows, {len(orig.dtype.names)} columns OK"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--paramfile", default=None,
                    help="record these run parameters in the FITS header")
    ap.add_argument("--outdir", default=".",
                    help="directory for the .fits files (default: cwd)")
    ap.add_argument("--no-validate", action="store_true")
    args = ap.parse_args(argv)

    params = None
    if args.paramfile:
        from pinocchio_jax.config import read_parameter_file
        params = read_parameter_file(args.paramfile)

    status = 0
    for path in args.files:
        if "catalog" in path:
            out = pfits.convert_catalog_to_fits(path, params, args.outdir)
        elif "histories" in path:
            out = pfits.convert_histories_to_fits(path, params, args.outdir)
        elif "plc" in path:
            out = convert_plc_to_fits(path, params, args.outdir)
        else:
            print(f"skip (unrecognized product): {path}")
            continue
        msg = f"{path} -> {out}"
        if not args.no_validate and "histories" not in path:
            ok, detail = validate(out, path)
            msg += f"  [{'VALID' if ok else 'INVALID'}: {detail}]"
            status |= 0 if ok else 1
        print(msg)
    return status


if __name__ == "__main__":
    sys.exit(main())
