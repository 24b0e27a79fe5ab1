"""Ellipsoidal collapse-time kernel.

Batched, branch-free re-implementation of the reference's per-particle
collapse solve (collapse_times.c):
  - Hessian invariants + closed-form eigenvalues, ordered decreasing
    (inverse_collapse_time, collapse_times.c:679-776; ord :1354-1363)
  - ELL_CLASSIC: smallest non-negative root of the 3rd-order ellipsoidal
    collapse equation with the spherical-collapse correction
    (ell_classic, collapse_times.c:114-221, Monaco 1996a)
  - conversion of the growth-at-collapse b_c to F = 1 + z_c through the
    inverse linear growing mode (ell, collapse_times.c:404-427)

The C code's if/else ladder becomes a jnp.where lattice; every division and
sqrt is guarded so both sides of each select are finite.  Runs as one fused
XLA elementwise kernel over the full grid — the OpenMP loop at
collapse_times.c:545-591 becomes data parallelism on the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SMALL = 1e-20
BIG = 1e10


def _safe_div(a, b):
    ok = jnp.abs(b) > 0
    return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def eigenvalues_descending(d):
    """Eigenvalues of the symmetric Hessian given its 6 components
    [6, ...] in ider order (xx, yy, zz, xy, xz, yz), sorted descending.

    Follows inverse_collapse_time (collapse_times.c:679-749); returns
    (l1, l2, l3, fail) where fail flags the q^3 < r^2 or q < 0 branch that
    the reference maps to F = -10.

    The components stay as separate [N,N,N] arrays: a trailing axis of 6
    would make every elementwise access strided.
    """
    d0, d1, d2, d3, d4, d5 = (d[i] for i in range(6))
    mu1 = d0 + d1 + d2
    mu1_2 = mu1 * mu1
    mu2 = (0.5 * mu1_2 - 0.5 * (d0 * d0 + d1 * d1 + d2 * d2)
           - (d3 * d3 + d4 * d4 + d5 * d5))
    mu3 = (d0 * d1 * d2 + 2.0 * d3 * d4 * d5
           - d0 * d5 * d5 - d1 * d4 * d4 - d2 * d3 * d3)
    q = (mu1_2 - 3.0 * mu2) / 9.0
    r = -(2.0 * mu1_2 * mu1 - 9.0 * mu1 * mu2 + 27.0 * mu3) / 54.0

    diagonal = q == 0.0
    fail = (~diagonal) & ((q * q * q < r * r) | (q < 0.0))

    sq = 2.0 * _safe_sqrt(q)
    arg = jnp.clip(_safe_div(2.0 * r, q * sq), -1.0, 1.0)
    t = jnp.arccos(arg)
    third = 1.0 / 3.0
    # cos((t + 2pi k)/3) for k=0,1,2 from one cos + one sqrt:
    # t/3 in [0, pi/3] so sin(t/3) = sqrt(1 - cos^2) >= 0
    c = jnp.cos(t * third)
    sn = _safe_sqrt(1.0 - c * c)
    HALF_SQRT3 = 0.8660254037844386
    x1 = -sq * c + mu1 * third
    x2 = -sq * (-0.5 * c - HALF_SQRT3 * sn) + mu1 * third
    x3 = -sq * (-0.5 * c + HALF_SQRT3 * sn) + mu1 * third

    x1 = jnp.where(diagonal, d0, x1)
    x2 = jnp.where(diagonal, d1, x2)
    x3 = jnp.where(diagonal, d2, x3)

    hi = jnp.maximum(jnp.maximum(x1, x2), x3)
    lo = jnp.minimum(jnp.minimum(x1, x2), x3)
    mid = x1 + x2 + x3 - hi - lo
    return hi, mid, lo, fail


def ell_classic(l1, l2, l3):
    """Growing mode b_c at collapse; -0.1 when the ellipsoid never
    collapses (ell_classic, collapse_times.c:114-221)."""
    delta = l1 + l2 + l3
    det = l1 * l2 * l3
    den = det / 126.0 + 5.0 * l1 * delta * (delta - l1) / 84.0

    # --- 1st/2nd-order branches when den vanishes ---
    zeldovich = jnp.where(l1 > 0.0, _safe_div(1.0, l1), -0.1)
    dis = 7.0 * l1 * (l1 + 6.0 * delta)
    ell2 = _safe_div(7.0 * l1 - _safe_sqrt(dis), 3.0 * l1 * (l1 - delta))
    ell2 = jnp.where((dis < 0.0) | (ell2 < 0.0), -0.1, ell2)
    ell_den0 = jnp.where(jnp.abs(delta - l1) < SMALL, zeldovich, ell2)

    # --- full 3rd-order branch ---
    rden = _safe_div(1.0, den)
    a1 = 3.0 * l1 * (delta - l1) / 14.0 * rden
    a2 = l1 * rden
    a3 = -rden
    q = (a1 * a1 - 3.0 * a2) / 9.0
    r = (2.0 * a1 ** 3 - 9.0 * a1 * a2 + 27.0 * a3) / 54.0
    r2q3 = r * r - q ** 3

    # single real root (spherical / quasi-spherical)
    sq1 = jnp.cbrt(_safe_sqrt(r2q3) + jnp.abs(r))
    ell_a = (-jnp.sign(r) * (sq1 + _safe_div(q, sq1)) - a1 / 3.0)
    ell_a = jnp.where(ell_a < 0.0, -0.1, ell_a)

    # three real roots: smallest non-negative (same trig reduction as in
    # eigenvalues_descending)
    sq2 = 2.0 * _safe_sqrt(q)
    t = jnp.arccos(jnp.clip(_safe_div(2.0 * r, q * sq2), -1.0, 1.0))
    third = 1.0 / 3.0
    c = jnp.cos(t * third)
    sn = _safe_sqrt(1.0 - c * c)
    HALF_SQRT3 = 0.8660254037844386
    s1 = -sq2 * c - a1 * third
    s2 = -sq2 * (-0.5 * c - HALF_SQRT3 * sn) - a1 * third
    s3 = -sq2 * (-0.5 * c + HALF_SQRT3 * sn) - a1 * third
    s1 = jnp.where(s1 < 0.0, BIG, s1)
    s2 = jnp.where(s2 < 0.0, BIG, s2)
    s3 = jnp.where(s3 < 0.0, BIG, s3)
    ell_b = jnp.minimum(jnp.minimum(s1, s2), s3)
    ell_b = jnp.where(ell_b == BIG, -0.1, ell_b)

    ell3 = jnp.where(r2q3 > 0.0, ell_a, ell_b)
    out = jnp.where(jnp.abs(den) < SMALL, ell_den0, ell3)
    out = jnp.where(jnp.abs(l1) < SMALL, -0.1, out)

    # spherical-collapse correction (collapse_times.c:215-218)
    inv_del = _safe_div(1.0, delta)
    corr = -0.364 * inv_del * jnp.exp(
        -6.5 * (l1 - l2) * inv_del - 2.8 * (l2 - l3) * inv_del)
    return jnp.where((delta > 0.0) & (out > 0.0), out + corr, out)


def make_inverse_growth_table(cosmo, n: int = 4096):
    """Uniform table of log10 a vs log10 D for inverting the growing mode
    on device with pure arithmetic indexing (no searchsorted: binary-search
    gathers are slow on the device).

    Returns (tab_values[n], (lo, dx)) where tab_values[i] = log10 a at
    log10 D = lo + i*dx; ends extend linearly like the reference's
    my_spline_eval (cosmo.c:2016-2027).
    """
    logD = np.asarray(cosmo.sp_grow1.y, dtype=np.float64)
    loga = np.asarray(cosmo.sp_grow1.x, dtype=np.float64)
    # pad the domain so any realistic b_c lands inside
    lo = logD[0] - 10.0
    hi = logD[-1] + 5.0
    grid = np.linspace(lo, hi, n)
    lo_slope = (loga[1] - loga[0]) / (logD[1] - logD[0])
    hi_slope = (loga[-1] - loga[-2]) / (logD[-1] - logD[-2])
    vals = np.interp(grid, logD, loga,
                     left=np.nan, right=np.nan)
    below = grid < logD[0]
    above = grid > logD[-1]
    vals[below] = loga[0] + (grid[below] - logD[0]) * lo_slope
    vals[above] = loga[-1] + (grid[above] - logD[-1]) * hi_slope
    return (jnp.asarray(vals, jnp.float32),
            (np.float32(lo), np.float32(grid[1] - grid[0])))


def make_inverse_table_from_curve(logD_curve, loga_grid, n: int = 4096):
    """Uniform inverse table log10 D -> log10 a from an arbitrary
    monotonic growth curve (used per smoothing radius when growth is
    scale-dependent)."""
    logD = np.asarray(logD_curve, dtype=np.float64)
    loga = np.asarray(loga_grid, dtype=np.float64)
    keep = np.concatenate([[True], np.diff(logD) > 0])
    logD, loga = logD[keep], loga[keep]
    lo = logD[0] - 10.0
    hi = logD[-1] + 5.0
    grid = np.linspace(lo, hi, n)
    lo_slope = (loga[1] - loga[0]) / (logD[1] - logD[0])
    hi_slope = (loga[-1] - loga[-2]) / (logD[-1] - logD[-2])
    vals = np.interp(grid, logD, loga, left=np.nan, right=np.nan)
    below = grid < logD[0]
    above = grid > logD[-1]
    vals[below] = loga[0] + (grid[below] - logD[0]) * lo_slope
    vals[above] = loga[-1] + (grid[above] - logD[-1]) * hi_slope
    return (np.asarray(vals, np.float32), np.float32(lo),
            np.float32(grid[1] - grid[0]))


def uniform_lookup(tab, lo, dx, x):
    """Linear interpolation on a uniform table via computed indices."""
    t = (x - lo) / dx
    t = jnp.clip(t, 0.0, tab.shape[0] - 1.001)
    i = t.astype(jnp.int32)
    w = t - i.astype(jnp.float32)
    return tab[i] * (1.0 - w) + tab[i + 1] * w


# ------------------------------------------------------------------
# polynomial inverse growth: a dynamic gather per cell costs more than
# the whole eigenvalue+ellipsoid math, so the smooth log10 a(log10 D)
# curve is fit once on the host and evaluated as a static-indexed Horner
# polynomial, with the reference's linear extrapolation outside the fit
# window (my_spline_eval, cosmo.c:2016-2027)
# ------------------------------------------------------------------

INVGROW_DEG = 16
INVGROW_PACK = INVGROW_DEG + 1 + 6     # coeffs + lo,hi + 2 linear tails


def fit_inverse_growth(logD_curve, loga_grid) -> np.ndarray:
    """Packed fp32 parameters [coeffs(deg+1 desc), lo, hi, a_lo, b_lo,
    a_hi, b_hi] such that log10 a(x) = poly(x) on [lo, hi] and the linear
    tails continue the curve outside."""
    logD = np.asarray(logD_curve, np.float64)
    loga = np.asarray(loga_grid, np.float64)
    keep = np.concatenate([[True], np.diff(logD) > 0])
    logD, loga = logD[keep], loga[keep]
    lo, hi = logD[0], logD[-1]
    # dense resample, fit in normalized t in [-1, 1] (fp32-stable Horner)
    xs = np.linspace(lo, hi, 4096)
    ys = np.interp(xs, logD, loga)
    ts = (2.0 * xs - (lo + hi)) / (hi - lo)
    coeffs = np.polynomial.chebyshev.chebfit(ts, ys, INVGROW_DEG)
    poly = np.polynomial.chebyshev.cheb2poly(coeffs)[::-1]  # descending
    a_lo = (loga[1] - loga[0]) / (logD[1] - logD[0])
    b_lo = loga[0] - a_lo * lo
    a_hi = (loga[-1] - loga[-2]) / (logD[-1] - logD[-2])
    b_hi = loga[-1] - a_hi * hi
    out = np.concatenate([poly, [lo, hi, a_lo, b_lo, a_hi, b_hi]])
    return out.astype(np.float32)


def make_inverse_growth_fit(cosmo) -> np.ndarray:
    return fit_inverse_growth(cosmo.sp_grow1.y, cosmo.sp_grow1.x)


def eval_inverse_growth(pack, x):
    """log10 a at log10 D = x from a packed fit (vector `pack` indexed
    statically: no gathers)."""
    lo = pack[INVGROW_DEG + 1]
    hi = pack[INVGROW_DEG + 2]
    t = jnp.clip((2.0 * x - (lo + hi)) / (hi - lo), -1.0, 1.0)
    acc = pack[0] * jnp.ones_like(x)
    for k in range(1, INVGROW_DEG + 1):
        acc = acc * t + pack[k]
    below = pack[INVGROW_DEG + 3] * x + pack[INVGROW_DEG + 4]
    above = pack[INVGROW_DEG + 5] * x + pack[INVGROW_DEG + 6]
    return jnp.where(x < lo, below, jnp.where(x > hi, above, acc))


@partial(jax.jit, static_argnames=("interp",))
def collapse_update_table(derivs, Fmax, Rmax, ismooth, ct_tab, ct_dv,
                          ct_idx_map, ct_ampl, ct_tab2=None,
                          interp: str = "trilinear"):
    """collapse_update variant for TABULATED_CT / ELL_SNG: F comes from
    interpolation of the per-radius collapse-time table in the chosen
    variant (interpolate_collapse_time, collapse_times.c:1139-1231;
    ct_tab2 = delta-spline second derivatives for the spline variants)."""
    from . import tabulated
    delta = derivs[0] + derivs[1] + derivs[2]
    l1, l2, l3, fail = eigenvalues_descending(derivs)
    F = tabulated.interp_F(interp, ct_tab, ct_tab2, ct_dv, ct_idx_map,
                           ct_ampl, l1, l2, l3)
    F = jnp.where(fail, -10.0, F)
    upd = Fmax < F
    Fmax = jnp.where(upd, F, Fmax)
    Rmax = jnp.where(upd, ismooth, Rmax)
    return Fmax, Rmax, _safe_mean(delta), _safe_mean(delta * delta)


def _safe_mean(x):
    """Hierarchical fp32 mean: a flat reduction over ~1e8+ values loses
    late increments to ulp starvation (at 512^3 the grid variance came out
    16% low); per-axis partial means keep every accumulator small."""
    return jnp.mean(jnp.mean(jnp.mean(x, axis=-1), axis=-1))


@partial(jax.jit, static_argnames=())
def collapse_update(derivs, Fmax, Rmax, ismooth, invgrow_pack):
    """One smoothing radius of compute_collapse_times
    (collapse_times.c:431-673): new collapse times F from the Hessian stack
    [6, N, N, N], running max into (Fmax, Rmax), plus the delta stats.

    invgrow_pack: polynomial inverse-growth fit (fit_inverse_growth) —
    static-indexed arithmetic instead of a dynamic table gather.
    Returns (Fmax, Rmax, mean_delta, mean_delta_sq).
    """
    delta = derivs[0] + derivs[1] + derivs[2]
    l1, l2, l3, fail = eigenvalues_descending(derivs)
    bc = ell_classic(l1, l2, l3)
    # F = 1 + z_c = 10^-log10(a_c)
    loga_c = eval_inverse_growth(invgrow_pack,
                                 jnp.log10(jnp.maximum(bc, 1e-30)))
    F = jnp.where(bc > 0.0, jnp.exp2(-3.321928094887362 * loga_c), 0.0)
    F = jnp.where(fail, -10.0, F)

    upd = Fmax < F
    Fmax = jnp.where(upd, F, Fmax)
    Rmax = jnp.where(upd, ismooth, Rmax)
    return Fmax, Rmax, _safe_mean(delta), _safe_mean(delta * delta)
