#!/usr/bin/env python
"""Standalone FITS schema/content validator (ValidateFits.py analog).

Driven by the run's parameter file like the reference
(scripts/ValidateFits.py:16-120): derives RunFlag and the output-redshift
list, then for each converted product (catalog per output z, plc,
histories) checks that

  * the FITS file exists and parses,
  * the row counts match the header cards (NHALOS / NTREES / NBRANCH),
  * every table column compares bit-for-bit against the original binary
    or ascii .out file read back through pinocchio_jax.io.readers.

Exit status = number of errors found.

Usage:
    python scripts/validate_fits.py <parameter_file> [--dir DIR]
        [--no-catalogs] [--no-plc] [--no-histories]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinocchio_jax.config import read_parameter_file      # noqa: E402
from pinocchio_jax.io import fits as pfits                # noqa: E402
from pinocchio_jax.io import readers                      # noqa: E402


def _compare_columns(rec, fits_rec, label):
    errors = 0
    for field in fits_rec.dtype.names:
        if field not in rec.dtype.names:
            print(f"ERROR [{label}]: column {field} missing in source")
            errors += 1
            continue
        if not np.array_equal(np.asarray(fits_rec[field]),
                              np.asarray(rec[field])):
            print(f"ERROR [{label}]: column {field} differs")
            errors += 1
    return errors


def validate_catalog(path, directory):
    errors = 0
    fits_path = path[:-3] + "fits"
    if not os.path.exists(fits_path):
        print(f"ERROR: {fits_path} not found")
        return 1
    rec = readers.read_catalog(path)
    name, hdr, fits_rec = pfits.read_fits(fits_path)[0]
    print(f"{os.path.basename(path)}: {len(rec)} halos, "
          f"fields {list(fits_rec.dtype.names)}")
    if int(hdr.get("NHALOS", -1)) != len(rec):
        print(f"ERROR: NHALOS={hdr.get('NHALOS')} but file has {len(rec)}")
        errors += 1
    errors += _compare_columns(rec, fits_rec, os.path.basename(path))
    return errors


def validate_plc(path, directory):
    errors = 0
    fits_path = path[:-3] + "fits"
    if not os.path.exists(fits_path):
        print(f"ERROR: {fits_path} not found")
        return 1
    rec = readers.read_plc(path)
    name, hdr, fits_rec = pfits.read_fits(fits_path)[0]
    print(f"{os.path.basename(path)}: {len(rec)} PLC halos")
    if int(hdr.get("NHALOS", -1)) != len(rec):
        print(f"ERROR: NHALOS={hdr.get('NHALOS')} but file has {len(rec)}")
        errors += 1
    errors += _compare_columns(rec, fits_rec, os.path.basename(path))
    return errors


def validate_histories(path, directory):
    errors = 0
    fits_path = path[:-3] + "fits"
    if not os.path.exists(fits_path):
        print(f"ERROR: {fits_path} not found")
        return 1
    ntrees, trees = readers.read_histories(path)
    branches = (np.concatenate(trees) if trees
                else np.zeros(0, readers.HISTORIES_DTYPE))
    hdus = pfits.read_fits(fits_path)
    name, hdr, fits_rec = hdus[0]
    print(f"{os.path.basename(path)}: {ntrees} trees, "
          f"{len(branches)} branches")
    if int(hdr.get("NTREES", -1)) != ntrees:
        print(f"ERROR: NTREES={hdr.get('NTREES')} but file has {ntrees}")
        errors += 1
    if int(hdr.get("NBRANCH", -1)) != len(branches):
        print(f"ERROR: NBRANCH={hdr.get('NBRANCH')} vs {len(branches)}")
        errors += 1
    errors += _compare_columns(branches, fits_rec, os.path.basename(path))
    # POINTERS extension: per-tree branch counts must sum correctly
    if len(hdus) > 1:
        _, _, ptr = hdus[1]
        if int(ptr["Nbranches"].sum()) != len(branches):
            print("ERROR: POINTERS Nbranches do not sum to NBRANCH")
            errors += 1
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parameter_file")
    ap.add_argument("--dir", default=None,
                    help="directory with the .out/.fits files (default: "
                    "the parameter file's directory)")
    ap.add_argument("--no-catalogs", action="store_true")
    ap.add_argument("--no-plc", action="store_true")
    ap.add_argument("--no-histories", action="store_true")
    args = ap.parse_args(argv)

    params = read_parameter_file(args.parameter_file)
    directory = args.dir or os.path.dirname(
        os.path.abspath(args.parameter_file))
    print(f"RunFlag: {params.RunFlag}; outputs: {params.output_z}")

    errors = 0
    if not args.no_catalogs:
        for z in params.output_z:
            path = os.path.join(
                directory, f"pinocchio.{z:6.4f}.{params.RunFlag}.catalog.out")
            if os.path.exists(path) or os.path.exists(path + ".0"):
                errors += validate_catalog(path, directory)
            else:
                print(f"skipping missing {os.path.basename(path)}")
    if not args.no_plc:
        path = os.path.join(directory, f"pinocchio.{params.RunFlag}.plc.out")
        if os.path.exists(path) or os.path.exists(path + ".0"):
            errors += validate_plc(path, directory)
    if not args.no_histories:
        path = os.path.join(directory,
                            f"pinocchio.{params.RunFlag}.histories.out")
        if os.path.exists(path) or os.path.exists(path + ".0"):
            errors += validate_histories(path, directory)

    print(f"validation finished with {errors} error(s)")
    return errors


if __name__ == "__main__":
    sys.exit(main())
