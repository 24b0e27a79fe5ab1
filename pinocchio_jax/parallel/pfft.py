"""Distributed 3-D FFT + k-space kernels over a device mesh.

Replacement for the reference's PFFT slab/pencil/volumes
decomposition (fmax-pfft.c, initialization.c:1205-1379).  Three
decompositions, mirroring set_fft_decomposition's 1-D / 2-D / 3-D
procmesh choice:

* **Slab** (1-D mesh): real fields sharded along x; the r2c transform runs
  the two local axes on-device and gathers the x axis with a single
  all_to_all (the collective PFFT performs internally with MPI_Alltoall).

* **Pencil** (2-D mesh, axes 'a' x 'b'): real fields sharded along x and y;
  the transform does z locally, then two *subgroup* all_to_alls (one within
  each mesh row, one within each column) — the transposes run within mesh
  rows/columns instead of one global all-to-all, and the per-device slab
  height N/p is replaced by an N/pa x N/pb pencil, removing the slab limit
  p <= N (initialization.c:1236-1301 picks pencils for the same reason).

* **Volumes** (3-D mesh 'a' x 'b' x 'c'): real fields sharded along all
  three axes; three subgroup all_to_alls per transform (VolumeDecomp
  docstring) — the reference's fall-through when the task count exceeds
  pencil capacity (initialization.c:1205-1234).

Layouts (global shapes, p = mesh size, Nh = N//2+1):
  slab    real [N, N, N]  P('x', None, None)   k [N, N, Nh]   P(None,'x',None)
  pencil  real [N, N, N]  P('a', 'b', None)    k [N, N, Nhp]  P(None,'a','b')
  volumes real [N, N, N]  P('a', 'b', 'c')     k [N, N, Nhp]  P(None,'a',('b','c'))
where Nhp = g*ceil(Nh/g) (g = pb or pb*pc): the rfft half-axis is
zero-padded so the kz blocks split evenly; padded planes stay exactly
zero through every linear step and are sliced off before the inverse r2c
axis.

The Green's-function x smoothing multiply is computed per shard with the
global k offsets from the mesh coordinates, exactly mirroring the per-task
k-loop of compute_derivative (fmax-pfft.c:306-397).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import irfft_z
from ..grids import signed_modes

AX = "x"    # mesh axis name for the slab decomposition
AXA = "a"   # pencil mesh axes
AXB = "b"
AXC = "c"   # third axis of the volumes (3-D) mesh


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D (slab) mesh over the first n devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AX,))


def make_pencil_mesh(n_devices: int | None = None,
                     shape: tuple | None = None) -> Mesh:
    """2-D (pencil) mesh; factorization defaults to the most square
    pa x pb split (set_fft_decomposition's 2-D branch,
    initialization.c:1266-1301 picks the gcd-balanced procmesh)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if shape is None:
        pa = int(math.sqrt(n))
        while n % pa:
            pa -= 1
        shape = (pa, n // pa)
    assert shape[0] * shape[1] == n
    return Mesh(np.array(devs[:n]).reshape(shape), (AXA, AXB))


def make_volume_mesh(n_devices: int | None = None,
                     shape: tuple | None = None) -> Mesh:
    """3-D (volumes) mesh; factorization defaults to the most cubic
    pa x pb x pc split (the 3-D procmesh fallback of
    set_fft_decomposition, initialization.c:1205-1379, used when the
    task count exceeds what a pencil mesh can hold)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if shape is None:
        pa = round(n ** (1.0 / 3.0))
        while n % pa:
            pa -= 1
        rest = n // pa
        pb = int(math.sqrt(rest))
        while rest % pb:
            pb -= 1
        shape = tuple(sorted((pa, pb, rest // pb), reverse=True))
    assert shape[0] * shape[1] * shape[2] == n
    return Mesh(np.array(devs[:n]).reshape(shape), (AXA, AXB, AXC))


def shard_map_fn(mesh, fn, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _safe_inv(k2):
    return jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)


class SlabDecomp:
    """1-D decomposition: one global all_to_all per transform."""

    def __init__(self, mesh: Mesh, N: int):
        assert len(mesh.axis_names) == 1
        self.mesh, self.N = mesh, N
        self.p = mesh.devices.size
        assert N % self.p == 0, "slab needs N % n_devices == 0"
        self.real_spec = P(AX, None, None)
        self.k_spec = P(None, AX, None)
        self.k_global_shape = (N, N, N // 2 + 1)

    def real_sharding(self):
        return NamedSharding(self.mesh, self.real_spec)

    def kspace_sharding(self):
        return NamedSharding(self.mesh, self.k_spec)

    def fwd_local(self, r):
        """local [N/p, N, N] real -> local [N, N/p, Nh] complex."""
        k = jnp.fft.rfft(r, axis=2)
        k = jnp.fft.fft(k, axis=1)
        k = jax.lax.all_to_all(k, AX, split_axis=1, concat_axis=0,
                               tiled=True)
        return jnp.fft.fft(k, axis=0)

    def inv_local(self, k):
        """local [N, N/p, Nh] complex -> local [N/p, N, N] real."""
        k = jnp.fft.ifft(k, axis=0)
        k = jax.lax.all_to_all(k, AX, split_axis=0, concat_axis=1,
                               tiled=True)
        k = jnp.fft.ifft(k, axis=1)
        return irfft_z(k, self.N)

    def local_kvectors(self):
        """k in grid units for the transposed k layout, with the ky block
        offset by this shard's mesh coordinate."""
        N, p = self.N, self.p
        me = jax.lax.axis_index(AX)
        mloc = N // p
        two_pi = 2.0 * np.pi / N
        mx = jnp.asarray(signed_modes(N), jnp.float32).reshape(N, 1, 1)
        my_idx = me * mloc + jnp.arange(mloc)
        my = jnp.where(my_idx <= N // 2, my_idx, my_idx - N
                       ).astype(jnp.float32).reshape(1, mloc, 1)
        mz = jnp.arange(N // 2 + 1, dtype=jnp.float32
                        ).reshape(1, 1, N // 2 + 1)
        return two_pi * mx, two_pi * my, two_pi * mz


class PencilDecomp:
    """2-D decomposition: two subgroup all_to_alls per transform."""

    def __init__(self, mesh: Mesh, N: int):
        assert tuple(mesh.axis_names) == (AXA, AXB)
        self.mesh, self.N = mesh, N
        self.pa, self.pb = mesh.devices.shape
        assert N % self.pa == 0 and N % self.pb == 0, \
            "pencil needs N divisible by both mesh dims"
        Nh = N // 2 + 1
        self.Nhp = self.pb * ((Nh + self.pb - 1) // self.pb)
        self.real_spec = P(AXA, AXB, None)
        self.k_spec = P(None, AXA, AXB)
        self.k_global_shape = (N, N, self.Nhp)

    def real_sharding(self):
        return NamedSharding(self.mesh, self.real_spec)

    def kspace_sharding(self):
        return NamedSharding(self.mesh, self.k_spec)

    def fwd_local(self, r):
        """local [N/pa, N/pb, N] real -> local [N, N/pa, Nhp/pb] complex."""
        Nh = self.N // 2 + 1
        k = jnp.fft.rfft(r, axis=2)
        k = jnp.pad(k, ((0, 0), (0, 0), (0, self.Nhp - Nh)))
        # row transpose: gather y, scatter kz within each 'b' group
        k = jax.lax.all_to_all(k, AXB, split_axis=2, concat_axis=1,
                               tiled=True)
        k = jnp.fft.fft(k, axis=1)
        # column transpose: gather x, scatter ky within each 'a' group
        k = jax.lax.all_to_all(k, AXA, split_axis=1, concat_axis=0,
                               tiled=True)
        return jnp.fft.fft(k, axis=0)

    def inv_local(self, k):
        """local [N, N/pa, Nhp/pb] complex -> local [N/pa, N/pb, N] real."""
        Nh = self.N // 2 + 1
        k = jnp.fft.ifft(k, axis=0)
        k = jax.lax.all_to_all(k, AXA, split_axis=0, concat_axis=1,
                               tiled=True)
        k = jnp.fft.ifft(k, axis=1)
        k = jax.lax.all_to_all(k, AXB, split_axis=1, concat_axis=2,
                               tiled=True)
        return irfft_z(k[:, :, :Nh], self.N)

    def local_kvectors(self):
        """k in grid units for the pencil k layout: ky offset by the 'a'
        coordinate, kz by the 'b' coordinate (padded kz tail carries
        exactly-zero modes; its k values are inert)."""
        N = self.N
        a = jax.lax.axis_index(AXA)
        b = jax.lax.axis_index(AXB)
        mloc_y = N // self.pa
        mloc_z = self.Nhp // self.pb
        two_pi = 2.0 * np.pi / N
        mx = jnp.asarray(signed_modes(N), jnp.float32).reshape(N, 1, 1)
        my_idx = a * mloc_y + jnp.arange(mloc_y)
        my = jnp.where(my_idx <= N // 2, my_idx, my_idx - N
                       ).astype(jnp.float32).reshape(1, mloc_y, 1)
        mz = (b * mloc_z + jnp.arange(mloc_z)).astype(jnp.float32
                                                      ).reshape(1, 1, mloc_z)
        return two_pi * mx, two_pi * my, two_pi * mz


class VolumeDecomp:
    """3-D (volumes) decomposition: three subgroup all_to_alls per
    transform (the reference's 3-D procmesh fall-through when the task
    count exceeds pencil capacity, initialization.c:1205-1379,
    fmax-pfft.c:95-111).

    Real fields are sharded along all three axes [N/pa, N/pb, N/pc]; the
    forward transform gathers z within each 'c' line (scattering y),
    transforms z, gathers y across the combined ('b','c') plane
    (scattering kz), transforms y, then gathers x within each 'a' line
    (scattering ky) and transforms x, landing on the k layout
    [N, N/pa, Nhp/(pb*pc)] = P(None, 'a', ('b','c')).  The combined
    ('b','c') collective enumerates its group b-major, which matches
    both the y-block ordering the 'c' scatter produced and the kz block
    offsets of local_kvectors."""

    def __init__(self, mesh: Mesh, N: int):
        assert tuple(mesh.axis_names) == (AXA, AXB, AXC)
        self.mesh, self.N = mesh, N
        self.pa, self.pb, self.pc = mesh.devices.shape
        pbc = self.pb * self.pc
        assert N % self.pa == 0 and N % self.pb == 0 \
            and (N // self.pb) % self.pc == 0, \
            "volumes needs N % pa == 0 and (N/pb) % pc == 0"
        Nh = N // 2 + 1
        self.Nhp = pbc * ((Nh + pbc - 1) // pbc)
        self.real_spec = P(AXA, AXB, AXC)
        self.k_spec = P(None, AXA, (AXB, AXC))
        self.k_global_shape = (N, N, self.Nhp)

    def real_sharding(self):
        return NamedSharding(self.mesh, self.real_spec)

    def kspace_sharding(self):
        return NamedSharding(self.mesh, self.k_spec)

    def fwd_local(self, r):
        """local [N/pa, N/pb, N/pc] real -> [N, N/pa, Nhp/(pb*pc)]."""
        Nh = self.N // 2 + 1
        # gather z within the 'c' line (scatter y)
        k = jax.lax.all_to_all(r, AXC, split_axis=1, concat_axis=2,
                               tiled=True)
        k = jnp.fft.rfft(k, axis=2)
        k = jnp.pad(k, ((0, 0), (0, 0), (0, self.Nhp - Nh)))
        # gather y across the ('b','c') plane (scatter kz)
        k = jax.lax.all_to_all(k, (AXB, AXC), split_axis=2,
                               concat_axis=1, tiled=True)
        k = jnp.fft.fft(k, axis=1)
        # gather x within the 'a' line (scatter ky)
        k = jax.lax.all_to_all(k, AXA, split_axis=1, concat_axis=0,
                               tiled=True)
        return jnp.fft.fft(k, axis=0)

    def inv_local(self, k):
        """local [N, N/pa, Nhp/(pb*pc)] complex -> [N/pa, N/pb, N/pc]."""
        Nh = self.N // 2 + 1
        k = jnp.fft.ifft(k, axis=0)
        k = jax.lax.all_to_all(k, AXA, split_axis=0, concat_axis=1,
                               tiled=True)
        k = jnp.fft.ifft(k, axis=1)
        k = jax.lax.all_to_all(k, (AXB, AXC), split_axis=1,
                               concat_axis=2, tiled=True)
        r = irfft_z(k[:, :, :Nh], self.N)
        return jax.lax.all_to_all(r, AXC, split_axis=2, concat_axis=1,
                                  tiled=True)

    def local_kvectors(self):
        """k in grid units for the volumes k layout: ky offset by the
        'a' coordinate, kz by the b-major ('b','c') group position
        (padded kz tail carries exactly-zero modes)."""
        N = self.N
        a = jax.lax.axis_index(AXA)
        b = jax.lax.axis_index(AXB)
        c = jax.lax.axis_index(AXC)
        mloc_y = N // self.pa
        mloc_z = self.Nhp // (self.pb * self.pc)
        two_pi = 2.0 * np.pi / N
        mx = jnp.asarray(signed_modes(N), jnp.float32).reshape(N, 1, 1)
        my_idx = a * mloc_y + jnp.arange(mloc_y)
        my = jnp.where(my_idx <= N // 2, my_idx, my_idx - N
                       ).astype(jnp.float32).reshape(1, mloc_y, 1)
        mz = ((b * self.pc + c) * mloc_z
              + jnp.arange(mloc_z)).astype(jnp.float32
                                           ).reshape(1, 1, mloc_z)
        return two_pi * mx, two_pi * my, two_pi * mz


def make_decomp(mesh: Mesh, N: int):
    naxes = len(mesh.axis_names)
    return (VolumeDecomp(mesh, N) if naxes == 3
            else PencilDecomp(mesh, N) if naxes == 2
            else SlabDecomp(mesh, N))


# ---------------- distributed transforms / kernels ----------------

def distributed_rfft3(decomp):
    """Forward transform: real-space sharding -> k-space sharding."""
    return shard_map_fn(decomp.mesh, decomp.fwd_local,
                        decomp.real_spec, decomp.k_spec)


def distributed_irfft3(decomp):
    return shard_map_fn(decomp.mesh, decomp.inv_local,
                        decomp.k_spec, decomp.real_spec)


def distributed_second_derivatives(decomp):
    """All 6 Hessian components of the smoothed potential, distributed.

    Input: kdensity in the decomposition's k layout; output [6, N, N, N]
    real-space stack.  6 inverse FFTs with one fused elementwise multiply
    each, like fmax.c:225-258.
    """
    def local(kden, R_grid):
        kx, ky, kz = decomp.local_kvectors()
        k2 = kx * kx + ky * ky + kz * kz
        base = kden * (jnp.exp(-0.5 * k2 * R_grid * R_grid)
                       * _safe_inv(k2)).astype(jnp.float32)
        kvec = (kx, ky, kz)
        outs = []
        for ia, ib in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
            outs.append(decomp.inv_local(base * (kvec[ia] * kvec[ib])))
        return jnp.stack(outs)

    return shard_map_fn(decomp.mesh, local, (decomp.k_spec, P()),
                        P(None, *decomp.real_spec))


def distributed_first_derivatives(decomp):
    """The 3 first derivatives i k_a / k^2 (one displacement stack)."""
    def local(kvector, growth):
        kx, ky, kz = decomp.local_kvectors()
        k2 = kx * kx + ky * ky + kz * kz
        base = kvector * (1j * growth) * _safe_inv(k2).astype(jnp.float32)
        return jnp.stack([decomp.inv_local(base * kx),
                          decomp.inv_local(base * ky),
                          decomp.inv_local(base * kz)])

    return shard_map_fn(decomp.mesh, local, (decomp.k_spec, P()),
                        P(None, *decomp.real_spec))


def distributed_first_derivatives_tab(decomp):
    """first derivatives with a per-mode growth factor from a uniform
    table over log10 |k| in grid units — the distributed form of the
    scale-dependent growth switch of compute_derivative
    (fmax-pfft.c:344-364); the table is replicated, each shard indexes it
    at its own k offsets."""
    def local(kvector, gtab, glo, gdx):
        kx, ky, kz = decomp.local_kvectors()
        k2 = kx * kx + ky * ky + kz * kz
        logk = 0.5 * jnp.log10(jnp.maximum(k2, 1e-12))
        t = jnp.clip((logk - glo) / gdx, 0.0, gtab.shape[0] - 1.001)
        i = t.astype(jnp.int32)
        w = t - i.astype(jnp.float32)
        growth = gtab[i] * (1.0 - w) + gtab[i + 1] * w
        base = kvector * (1j * growth) * _safe_inv(k2).astype(jnp.float32)
        return jnp.stack([decomp.inv_local(base * kx),
                          decomp.inv_local(base * ky),
                          decomp.inv_local(base * kz)])

    return shard_map_fn(decomp.mesh, local,
                        (decomp.k_spec, P(), P(), P()),
                        P(None, *decomp.real_spec))
