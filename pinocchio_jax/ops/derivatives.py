"""k-space derivative kernels: the heart of the fmax pipeline.

Replaces compute_derivative (fmax-pfft.c:255-441): multiply delta(k) by the
Green's function of the inverse Laplacian, a Gaussian smoothing window and
(optionally) a growth factor, then inverse-FFT.  The per-mode multiply is
a single fused elementwise op over the rfftn cube; the 6 Hessian
components share one smoothed field.

Conventions (greens_function, fmax-pfft.c:444-456):
  second derivative (ia, ib >= 1):  +k_ia k_ib / k^2      (no i factor)
  first derivative  (ia >= 1):      +i k_ia / k^2         (the real/imag
                                    swap at fmax-pfft.c:389-394 is a
                                    multiplication by i)
k is in grid units 2*pi*m/N and the smoothing radius in cell units, so the
products are dimensionless displacements in units of the inter-particle
distance, exactly as the reference stores them.

Derivative component order (fmax.c:235-239 'ider'):
  0:(1,1) 1:(2,2) 2:(3,3) 3:(1,2) 4:(1,3) 5:(2,3)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..backend import irfft3
from ..grids import k_grid_units

SECOND_DERIV_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _kvectors(N):
    return k_grid_units(N)


def smoothed_potential(kdensity, R_grid: jnp.ndarray, N: int):
    """delta(k) * exp(-k^2 R^2 / 2) / k^2 with the k=0 mode zeroed.

    This is the shared factor of all 6 second derivatives for one radius.
    """
    kx, ky, kz = _kvectors(N)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    smooth = jnp.exp(-0.5 * k2 * R_grid * R_grid)
    return kdensity * (smooth * inv_k2).astype(jnp.float32)


@partial(jax.jit, static_argnames=("N",))
def second_derivatives(kdensity, R_grid, N: int):
    """All 6 second derivatives of the smoothed inverse-Laplacian potential.

    Returns a [6, N, N, N] float32 stack in 'ider' order.  Equivalent to
    compute_second_derivatives (fmax.c:225-258) = 6 c2r FFTs."""
    kx, ky, kz = _kvectors(N)
    base = smoothed_potential(kdensity, R_grid, N)
    kvec = (kx, ky, kz)
    outs = []
    for ia, ib in SECOND_DERIV_PAIRS:
        outs.append(irfft3(base * (kvec[ia] * kvec[ib]), N))
    return jnp.stack(outs)


@partial(jax.jit, static_argnames=("N",))
def first_derivatives(kvector, growth, N: int):
    """The 3 first derivatives i k_a/k^2 of a k-space source, scaled by a
    growth factor: one LPT displacement field [3, N, N, N].

    Equivalent to compute_first_derivatives (fmax.c:193-222) at R=0 with
    the ScaleDep growth switch of fmax-pfft.c:344-364 reduced to a scalar
    (scale-independent growth).
    """
    kx, ky, kz = _kvectors(N)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    base = kvector * (1j * growth) * inv_k2.astype(jnp.float32)
    return jnp.stack([irfft3(base * kx, N),
                      irfft3(base * ky, N),
                      irfft3(base * kz, N)])


@partial(jax.jit, static_argnames=("N",))
def first_derivatives_tab(kvector, gtab, glo, gdx, N: int):
    """Like first_derivatives but with a per-mode growth factor from a
    uniform table over log10 |k| (grid units): the scale-dependent growth
    switch of compute_derivative (fmax-pfft.c:344-364).  NB the reference
    evaluates GrowingMode at |k| in grid units (fmax-pfft.c:340,350) —
    reproduced as-is."""
    kx, ky, kz = _kvectors(N)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    logk = 0.5 * jnp.log10(jnp.maximum(k2, 1e-12))
    t = jnp.clip((logk - glo) / gdx, 0.0, gtab.shape[0] - 1.001)
    i = t.astype(jnp.int32)
    w = t - i.astype(jnp.float32)
    growth = gtab[i] * (1.0 - w) + gtab[i + 1] * w
    base = kvector * (1j * growth) * inv_k2.astype(jnp.float32)
    return jnp.stack([irfft3(base * kx, N), irfft3(base * ky, N),
                      irfft3(base * kz, N)])


@partial(jax.jit, static_argnames=("N",))
def density_field(kdensity, N: int):
    """Real-space linear density contrast (c2r of delta(k))."""
    return irfft3(kdensity, N)
