"""Parity checks of one fmax engine or device mesh against another.

One set of limits, used by chip_smoke.py and
__graft_entry__.dryrun_multichip:

* collapse flips (|dF| > 0.1) in under FLIP_FRACTION of the cells.
  Near the branch points of the ellipsoidal solve, two runs that each
  agree with float64 to ~1e-6 flip ~0.03% of the cells: 0.029% for cuFFT
  against a float32 (HIGHEST) matmul DFT at 512^3 on an H100, 0.028%
  (H100) and 0.026% (CPU) for the out-of-core against the monolithic
  engine at 256^3.  A TF32 matmul DFT (6.5e-4 off float64) flips 0.047%, so
  this check does not tell TF32 from float32: it catches broken physics,
  not lost precision;
* the collapsed count (F >= 1) within 0.1%;
* every displacement within DV_TOL of max |v|: the precision guard
  (float32 runs agree to ~1e-6; the TF32 transform is ~1e-3 off).
"""

from __future__ import annotations

import numpy as np

FLIP_FRACTION = 1e-3
DV_TOL = 1e-4


class ParityError(AssertionError):
    """Two runs that should agree do not."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ParityError(msg)


def compare_fields(what: str, N: int, F_ref, F, vel_ref: dict, vel: dict,
                   log=print) -> dict:
    """Checks F against F_ref and each vel[key] against vel_ref[key]
    (dense stacks, or rows of the same cells) with the module's limits;
    logs one line and returns the readings."""
    F_ref, F = np.asarray(F_ref), np.asarray(F)
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    c_ref, c = int((F_ref >= 1.0).sum()), int((F >= 1.0).sum())
    dv = {}
    for key in vel_ref:
        a = np.asarray(vel_ref[key])
        b = np.asarray(vel[key])
        dv[key] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-3))
    log(f"[{what}] {N}^3: {nflip} collapse flips, collapsed {c} vs "
        f"{c_ref}, max|dv|/max|v| {dv}")
    _check(nflip < max(30, int(N ** 3 * FLIP_FRACTION)),
           f"{what}: {nflip} flips")
    _check(abs(c - c_ref) <= max(5, c_ref // 1000),
           f"{what}: collapsed {c} vs {c_ref}")
    for key, d in dv.items():
        _check(d < DV_TOL, f"{what}: {key} displacements off by {d}")
    return dict(flips=nflip, collapsed=c, collapsed_ref=c_ref, dv=dv)


def match_rows(ci_ref, ci) -> tuple:
    """(i_ref, i): positions of the cells common to two streamed row
    sets, which must cover all but 0.1% of the reference's cells."""
    common, i_ref, i = np.intersect1d(ci_ref, ci, return_indices=True)
    _check(len(common) > 0.999 * len(ci_ref),
           f"row sets share {len(common)} of {len(ci_ref)} cells")
    return i_ref, i
