#!/usr/bin/env python
"""HMF validation harness (scripts/HMF_validation.py analog): run the
validation deployment (configs/hmf_validation) end-to-end, compare the z=0
halo mass function to the Watson et al. 2013 fit and, when a reference
checkout is given, to the reference's shipped mass functions; log the
average residual, and save a comparison figure.

The reference records 'HMF Average Residual' = mean |n/n_fit - 1| over
populated bins (HMF_Validation/VALIDATION_log.txt:27-29, value 2.06e-01).

Usage: python scripts/hmf_validation.py [--outdir DIR] [--platform cpu]
           [--reference DIR]    # DIR/HMF_Validation of a V5.1 checkout
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="HMF_Validation_out")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--reference", default=None,
                    help="a reference PINOCCHIO V5.1 checkout, whose "
                    "HMF_Validation outputs the run is compared with")
    args = ap.parse_args()

    from pinocchio_jax.backend import setup
    setup(platform=args.platform)
    from pinocchio_jax.config import HMF_VALIDATION, read_parameter_file
    from pinocchio_jax.run import run_pipeline

    ref_dir = (os.path.join(args.reference, "HMF_Validation")
               if args.reference else None)
    os.makedirs(args.outdir, exist_ok=True)
    params = read_parameter_file(HMF_VALIDATION, norad=True,
                                 plc_enabled=False)
    run_pipeline(params, outdir=args.outdir)

    log_lines = []
    for z in params.output_z:
        mine = np.loadtxt(os.path.join(
            args.outdir, f"pinocchio.{z:6.4f}.test.mf.out"))
        sel = mine[:, 4] > 0
        resid = np.abs(mine[sel, 1] / mine[sel, 5] - 1.0).mean()
        line = f"z={z:6.4f}: HMF Average Residual vs Watson fit: {resid:.5g}"
        ref_path = os.path.join(ref_dir or "",
                                f"pinocchio.{z:6.4f}.test.mf.out")
        if ref_dir and os.path.exists(ref_path):
            ref = np.loadtxt(ref_path)
            n = min(len(mine), len(ref))
            tot = mine[:n, 4].sum() / max(ref[:n, 4].sum(), 1) - 1
            line += f"; halo count vs reference: {tot:+.2%}"
        log_lines.append(line)
        print(line)

    with open(os.path.join(args.outdir, "VALIDATION_log.txt"), "w") as fd:
        fd.write("\n".join(log_lines) + "\n")

    # comparison figure
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        mine = np.loadtxt(os.path.join(args.outdir,
                                       "pinocchio.0.0000.test.mf.out"))
        ref = (np.loadtxt(os.path.join(ref_dir,
                                       "pinocchio.0.0000.test.mf.out"))
               if ref_dir else None)
        fig, (ax, axr) = plt.subplots(
            2, 1, figsize=(6, 6), sharex=True,
            gridspec_kw=dict(height_ratios=[3, 1]))
        s = mine[:, 4] > 0
        ax.loglog(mine[s, 0], mine[s, 1], "o", ms=3, label="pinocchio-jax")
        if ref is not None:
            s = ref[:, 4] > 0
            ax.loglog(ref[s, 0], ref[s, 1], "s", ms=3, mfc="none",
                      label="reference")
        ax.loglog(mine[:, 0], mine[:, 5], "-", lw=1, label="Watson 2013")
        ax.legend()
        ax.set_ylabel("n(M)")
        s = mine[:, 4] > 0
        axr.semilogx(mine[s, 0], mine[s, 1] / mine[s, 5] - 1, "o", ms=3)
        axr.axhline(0, color="k", lw=0.5)
        axr.set_ylim(-0.5, 0.5)
        axr.set_xlabel("M [Msun/h]")
        axr.set_ylabel("n/fit - 1")
        fig.tight_layout()
        fig.savefig(os.path.join(args.outdir,
                                 "HMF_Validation_with_Watson_fit.png"),
                    dpi=130)
    except Exception as e:        # plotting must never fail the harness
        print("plotting skipped:", e)


if __name__ == "__main__":
    main()
