"""Initial conditions: Gaussian linear density field in k-space.

Replacement for the reference's N-GenIC-derived generator
(GenIC.c:73-460).  The reference achieves task-count invariance through a
distributed seed plane with a serial GSL RNG fast-forwarded per (kx,ky)
column (GenIC.c:482-1143); here the same *property* comes for free from
JAX's counter-based threefry PRNG: every mode's (phase, amplitude) pair is a
pure function of (seed, mode index), independent of device layout.

Math contract matched to the reference (GenIC.c:188-446):
  delta(k) = Box^{-3/2} * sqrt(P(|k|) * E) * exp(i phase),     E ~ Exp(1)
  FixedIC drops E (|delta| fixed to the mean, GenIC.c:375-376),
  PairedIC adds pi to the phase (GenIC.c:371-372),
  modes with any component at the Nyquist frequency are left empty,
  |m| > N/2 spherical cutoff (NYQUIST, GenIC.c:280-281),
  Hermitian symmetry is imposed on the kz=0 plane (GenIC.c:289-368).

Like the reference, delta(k) carries an N^3 factor (GenIC.c:428-445) that
cancels the 1/N^3 of the c2r transform (fmax-pfft.c:85 'norm'), which is
also jnp.fft.irfftn's default convention: the realized field variance is
sum_k P(k)/V as it must be.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .cosmology import Cosmology
from .grids import Grid


def pk_table(cosmo: Cosmology, grid: Grid, npts: int = 4096):
    """Dense log-log P(k) table covering the grid's k-range (host, fp64)."""
    kf = 2.0 * math.pi / grid.BoxSize
    logk = np.linspace(math.log10(kf) - 3.0,
                       math.log10(kf * grid.N * 2.0), npts)
    pk = cosmo.PowerSpectrum(10.0 ** logk)
    logpk = np.log10(np.maximum(pk, 1e-300))
    return (jnp.asarray(logk, jnp.float32), jnp.asarray(logpk, jnp.float32))


from functools import partial


@partial(jax.jit, static_argnames=("N", "fixed", "paired"))
def _kdensity_jit(key, logk_tab, logpk_tab, logkf, fac,
                  N: int, fixed: bool, paired: bool):
    Nh = N // 2 + 1
    kp, ka = jax.random.split(key)
    # phases and amplitude draws for every mode; counter-based => identical
    # for any device mesh (this is the reference's seed-plane invariance)
    phase = jax.random.uniform(kp, (N, N, Nh), jnp.float32,
                               0.0, 2.0 * np.pi)
    ampl = jax.random.uniform(ka, (N, N, Nh), jnp.float32,
                              minval=1.1754944e-38, maxval=1.0)

    # mode geometry, on device from iotas (no N^3 host arrays):
    # signed mode numbers, empty-mode mask (k=0, Nyquist components,
    # spherical cutoff, GenIC.c:280-281), log10 |k|
    ix = jnp.arange(N, dtype=jnp.int32).reshape(N, 1, 1)
    iy = jnp.arange(N, dtype=jnp.int32).reshape(1, N, 1)
    iz = jnp.arange(Nh, dtype=jnp.int32).reshape(1, 1, Nh)
    half = N // 2
    mx = jnp.where(ix <= half, ix, ix - N)
    my = jnp.where(iy <= half, iy, iy - N)
    m2 = mx * mx + my * my + iz * iz
    alive = (~((jnp.abs(mx) == half) | (jnp.abs(my) == half)
               | (iz == half))
             & (m2 > 0) & (m2 <= half * half))
    logkm = logkf + 0.5 * jnp.log10(jnp.maximum(m2, 1).astype(jnp.float32))

    # Hermitian symmetry on the kz=0 plane: a mode (ix, iy, 0) is
    # 'dependent' when ix > N/2, or ix == 0 and iy > N/2: it takes the
    # mirrored mode's draws with conjugation (GenIC.c:293-368)
    ix2 = ix[:, :, 0]
    iy2 = iy[0, :, :].reshape(1, N)
    dep = (ix2 > half) | ((ix2 == 0) & (iy2 > half))
    mix = (N - ix2) % N
    miy = (N - iy2) % N
    mix, miy = (jnp.broadcast_to(mix, (N, N)),
                jnp.broadcast_to(miy, (N, N)))

    # Hermitian symmetry on the kz=0 plane: dependent modes reuse the
    # mirrored mode's draws and conjugate
    ph0 = jnp.where(dep, phase[mix, miy, 0], phase[:, :, 0])
    am0 = jnp.where(dep, ampl[mix, miy, 0], ampl[:, :, 0])
    sign0 = jnp.where(dep, -1.0, 1.0).astype(jnp.float32)
    phase = phase.at[:, :, 0].set(ph0)
    ampl = ampl.at[:, :, 0].set(am0)
    sign = jnp.ones((N, N, Nh), jnp.float32).at[:, :, 0].set(sign0)

    pofk = 10.0 ** jnp.interp(logkm, logk_tab, logpk_tab)
    if not fixed:
        pofk = pofk * (-jnp.log(ampl))
    if paired:
        phase = phase + np.pi

    amp = jnp.where(alive, fac * jnp.sqrt(pofk), 0.0)
    return (amp * jnp.cos(phase)
            + 1j * (sign * amp * jnp.sin(phase))).astype(jnp.complex64)


def generate_kdensity(grid: Grid, cosmo: Cosmology, seed: int,
                      fixed: bool = False, paired: bool = False):
    """delta(k) on the rfftn grid [N, N, N//2+1], complex64."""
    logk_tab, logpk_tab = pk_table(cosmo, grid)
    key = jax.random.PRNGKey(seed)
    kf = 2.0 * math.pi / grid.BoxSize
    fac = grid.BoxSize ** -1.5 * float(grid.N) ** 3
    return _kdensity_jit(key, logk_tab, logpk_tab,
                         jnp.float32(math.log10(kf)), jnp.float32(fac),
                         grid.N, bool(fixed), bool(paired))


# ------------------------------------------------------------------
# kz-plane generator for the out-of-core (>= 1024^3) engine: the staged
# fmax never holds the full delta(k) — each pass regenerates the kz
# planes it needs.  Draws use a key folded per kz plane, so any plane
# batching (and any device layout) reproduces the same field; the
# realization differs from generate_kdensity's (same statistics, same
# math contract, GenIC.c:188-446).
# ------------------------------------------------------------------

def kdensity_plane_fn(grid: Grid, cosmo: Cosmology, seed: int,
                      fixed: bool = False, paired: bool = False):
    """Returns a traceable f(kz: int32 scalar) -> [N, N] complex64
    producing delta(k) for one kz plane, safe to call inside jit/scan."""
    logk_tab, logpk_tab = pk_table(cosmo, grid)
    base_key = jax.random.PRNGKey(seed)
    N = grid.N
    kf = 2.0 * math.pi / grid.BoxSize
    logkf = jnp.float32(math.log10(kf))
    fac = jnp.float32(grid.BoxSize ** -1.5 * float(N) ** 3)
    half = N // 2

    ix = jnp.arange(N, dtype=jnp.int32).reshape(N, 1)
    iy = jnp.arange(N, dtype=jnp.int32).reshape(1, N)
    mx = jnp.where(ix <= half, ix, ix - N)
    my = jnp.where(iy <= half, iy, iy - N)
    # Hermitian mirror within the kz=0 plane (GenIC.c:293-368)
    dep0 = (ix > half) | ((ix == 0) & (iy > half))
    mix = ((N - ix) % N).astype(jnp.int32)
    miy = ((N - iy) % N).astype(jnp.int32)

    def plane(kz):
        kz = jnp.asarray(kz, jnp.int32)
        key = jax.random.fold_in(base_key, kz)
        kp, ka = jax.random.split(key)
        phase = jax.random.uniform(kp, (N, N), jnp.float32,
                                   0.0, 2.0 * np.pi)
        ampl = jax.random.uniform(ka, (N, N), jnp.float32,
                                  minval=1.1754944e-38, maxval=1.0)
        m2 = (mx * mx + my * my).astype(jnp.int32) + kz * kz
        alive = (~((jnp.abs(mx) == half) | (jnp.abs(my) == half)
                   | (kz == half))
                 & (m2 > 0) & (m2 <= half * half))
        logkm = logkf + 0.5 * jnp.log10(
            jnp.maximum(m2, 1).astype(jnp.float32))

        is0 = kz == 0
        ph = jnp.where(is0 & dep0, phase[mix, miy], phase)
        am = jnp.where(is0 & dep0, ampl[mix, miy], ampl)
        sign = jnp.where(is0 & dep0, -1.0, 1.0).astype(jnp.float32)

        pofk = 10.0 ** jnp.interp(logkm, logk_tab, logpk_tab)
        if not fixed:
            pofk = pofk * (-jnp.log(am))
        if paired:
            ph = ph + np.pi
        amp = jnp.where(alive, fac * jnp.sqrt(pofk), 0.0)
        return (amp * jnp.cos(ph)
                + 1j * (sign * amp * jnp.sin(ph))).astype(jnp.complex64)

    return plane
