"""2LPT / 3LPT source terms and displacement fields.

Re-implements compute_LPT_displacements (LPT.c:32-235) on the rfftn layout:

  source_2LPT   = sum_{i<j} (phi,ii phi,jj - phi,ij^2)           (LPT.c:70-76)
  source_3LPT_1 = 3 det(phi,ij)                                  (LPT.c:79-87)
  source_3LPT_2 = 2 nabla^2(phi) * source_2LPT
                  - 2 sum_{ij} w_ij phi2,ij phi,ij               (LPT.c:89-141)
    with w_ij = 1 on the diagonal, 2 off-diagonal, and phi2 the potential
    whose FFT is the forward transform of source_2LPT.

Displacements are the 3 first derivatives of each k-space source scaled by
the order's growth factor (LPT.c:177-229); the Zel'dovich term is the first
derivative of delta(k) itself (fmax.c:335-346).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..backend import irfft3, rfft3
from ..grids import k_grid_units
from .derivatives import first_derivatives

# ider order: 0:xx 1:yy 2:zz 3:xy 4:xz 5:yz
_XX, _YY, _ZZ, _XY, _XZ, _YZ = range(6)


@partial(jax.jit, static_argnames=("N",))
def lpt_sources(sd, N: int):
    """k-space 2LPT and 3LPT sources from the R=0 Hessian stack [6,N,N,N].

    Returns (kvec_2LPT, kvec_3LPT_1, kvec_3LPT_2), each [N,N,N//2+1]
    complex64.  Costs 3 forward FFTs + 6 derivative inverse FFTs, exactly
    the reference's count (SURVEY.md L13).
    """
    src2 = (sd[_XX] * sd[_YY] + sd[_XX] * sd[_ZZ] + sd[_YY] * sd[_ZZ]
            - sd[_XY] * sd[_XY] - sd[_XZ] * sd[_XZ] - sd[_YZ] * sd[_YZ])
    src31 = 3.0 * (sd[_XX] * (sd[_YY] * sd[_ZZ] - sd[_YZ] * sd[_YZ])
                   - sd[_XY] * (sd[_XY] * sd[_ZZ] - sd[_XZ] * sd[_YZ])
                   + sd[_XZ] * (sd[_XY] * sd[_YZ] - sd[_XZ] * sd[_YY]))
    # factor 2: nabla2(phi) here is half the theoretical one (LPT.c:89-91)
    src32 = 2.0 * (sd[_XX] + sd[_YY] + sd[_ZZ]) * src2

    kvec2 = rfft3(src2)

    # second derivatives of the 2LPT potential (LPT.c:116-141)
    kx, ky, kz = k_grid_units(N)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    base2 = kvec2 * inv_k2.astype(jnp.float32)
    kvecs = (kx, ky, kz)
    pairs = ((0, 0, 1.0), (1, 1, 1.0), (2, 2, 1.0),
             (0, 1, 2.0), (0, 2, 2.0), (1, 2, 2.0))
    for ider, (ia, ib, w) in enumerate(pairs):
        phi2_ij = irfft3(base2 * (kvecs[ia] * kvecs[ib]), N)
        src32 = src32 - 2.0 * w * phi2_ij * sd[ider]

    kvec31 = rfft3(src31)
    kvec32 = rfft3(src32)
    return kvec2, kvec31, kvec32


def displacement_fields(kdensity, kvec2, kvec31, kvec32, growths, N: int):
    """All LPT displacement stacks at the orders' growth factors.

    growths = (D1, D2, D31, D32) evaluated at the storage redshift
    (ScaleDep.z[0]); returns dict of [3, N, N, N] float32 stacks matching
    products.Vel* of the reference (pinocchio.h:233-259).
    """
    D1, D2, D31, D32 = growths
    out = {"v1": first_derivatives(kdensity, jnp.float32(D1), N)}
    if kvec2 is not None:
        out["v2"] = first_derivatives(kvec2, jnp.float32(D2), N)
    if kvec31 is not None:
        out["v31"] = first_derivatives(kvec31, jnp.float32(D31), N)
        out["v32"] = first_derivatives(kvec32, jnp.float32(D32), N)
    return out
