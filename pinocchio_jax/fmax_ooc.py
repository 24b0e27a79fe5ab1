"""Out-of-core fmax engine: grids whose dense pipeline exceeds device memory.

The monolithic engine (fmax.py) needs ~6 f32 N^3 Hessian buffers plus the
LPT stacks resident — 84 GB at 1024^3 (planner.plan), more than one
80 GB card holds (planner.enforce_budget aborts).  The reference scales
to arbitrary N^3 on bounded memory by construction (allocations.c:37-251
byte budget); this module is that contract here: the working set is
capped by storing only the HALF-TRANSFORMED fields and materializing real
space in z-slabs.

Key identity: with delta(k) on the rfft layout [N, N, Nh],

    f(x, y, z) = sum_kz basis(kz, z) * ifft2(fac(k) * delta)(x, y, kz)

so each field needs one [N, Nh, N] pair of re/im half transforms (built
kz-plane by kz-plane with delta REGENERATED on the fly —
ic.kdensity_plane_fn, no resident delta; the (x, y) transforms are
batched XLA FFTs) and real space is recovered per z-slab as two dots
against the cos/sin bases of those Bz planes (a partial DFT over z).

Every device program here is a SHORT per-batch body driven by a Python
loop, with K=4 consecutive batches FUSED per dispatch where memory
allows (the group members).  Memory facts of XLA that shape the groups:
  * a dot that reads the big stack from inside while-loop context makes
    XLA hoist a FULL COPY (+12.45 GiB at 1024^3, loop-INVARIANT reads
    included) — so builder groups use fori (carried stacks are only
    WRITTEN, which aliases) while consumer groups UNROLL their K
    sections with an optimization_barrier between them, and the dense
    stores are 2-D slab rows [nsl, Bz*N*N] (a 3-D slab max-update made
    XLA relayout-copy the 2 GB Fmax grid);
  * a grouped member that reads a resident SPECTRUM from fori-loop
    context hoists a full copy of it (+2 GB at 1024^3) — so every
    spec-reading group (build_first/build_pair) UNROLLS its K sections
    instead, and the v-row streams stay per-slab at N >= 1024.

Half-transform storage is float32 when the float32 ledger fits the
device (planner.ooc_storage_dtype; through 1024^3 on an 80 GB card) and
bfloat16 past that.  Memory ledger at 1024^3 with bfloat16 storage (GiB):
  cycle:    us (12 arrays) 12.04 + Fmax f16 2.00 + temps    ~ 14.7
  2LPT:     us 12.04 + q2 (ALIASES the retired Fmax buffer)  = 14.3
  3LPT-a:   q31 z-slabs round-trip through the HOST
  3LPT-b:   w re/im f32 4.02 + q2hat 2.01 + u1/u2 4.01
            + fold temps ~2.3                               ~ 12.3
  v-streams: u_v (6) 6.01 + 3 spectra 6.03 + idx ~2.6       ~ 14.9
(float32 storage doubles the stack and spectrum terms.)  The 3LPT-b fold
therefore runs BEFORE the displacement stack u_v exists, and every
spectrum is deleted as soon as its stream lands.

Collapse models: ELL_CLASSIC (per-radius inverse-growth packs),
TABULATED_CT and ELL_SNG (per-radius ~1 MB collapse-time tables,
cycle_slab_tab), and scale-dependent growth (per-radius packs in the
cycle, per-mode D(k) tables in the LPT streams).  RECOMPUTE segments
are extra per-segment row streams over the same resident spectra;
DumpProducts checkpoints the landed sparse rows (io/dumps.py, deferred
past fragmentation by run_pipeline).  Only the timeless snapshot —
whose writer reads UNCOLLAPSED particles and therefore dense stacks —
keeps the monolithic engine (ooc_supported).

Reference map: compute_fmax fmax.c:36-190 (cycle), LPT.c:32-235
(sources), allocations.c:37-251 (the bounded-memory contract this
replaces).
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .config import Params
from .cosmology import Cosmology
from .grids import Grid, k_grid_units
from .ic import kdensity_plane_fn
from .fmax import (FmaxResult, Products, Smoothing, SparseProducts,
                   inverse_growth_packs)
from .ops import collapse

# ider order: 0:xx 1:yy 2:zz 3:xy 4:xz 5:yz
PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
PAIR_W = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)   # 3LPT-b off-diagonal weights


def _divisor_batch(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>=1)."""
    best = 1
    for b in range(1, min(n, target) + 1):
        if n % b == 0:
            best = b
    return best


def _seq(invariant: tuple, carry: tuple, j: int, K: int):
    """Order unrolled consumer sections strictly: thread the invariant
    reads AND the carry through one optimization_barrier so section
    j+1's stack reads depend on section j's completion — without it XLA
    co-schedules the sections' [Bz, N, N] f32 temps and the 1024^3
    cycle_group peak overshot HBM by ~0.6 GB (measured).  No-op after
    the last section."""
    if j >= K - 1:
        return invariant, carry
    nc = len(carry)
    out = jax.lax.optimization_barrier(tuple(invariant) + tuple(carry))
    return tuple(out[:-nc]), tuple(out[-nc:])


def _kz_schedule(n: int, target: int):
    """Disjoint (kz0, B) batches covering [0, n): full batches of size
    min(target, n) plus one REMAINDER batch.  Nh = N/2 + 1 is prime for
    N = 512 (257), so divisor-only batching degenerates to 257
    single-plane dispatches; a remainder batch costs one extra
    executable per member instead.
    Disjointness (no overlap) matters: fft2_batch transforms in place."""
    B = min(target, n)
    sched = [(i * B, B) for i in range(n // B)]
    if n % B:
        sched.append((n - n % B, n % B))
    return sched


def _zbases(N: int, z0, Bz: int, dtype, Nhp: int = None):
    """c2r bases C, S [Nhp, Bz] for output planes z0..z0+Bz-1 (traced
    z0), mod-N angle reduction for f32 fidelity.
    Rows at or past Nh = N/2+1 have weight ZERO (kz padding for the
    multi-chip sharded stacks)."""
    Nh = N // 2 + 1
    Nhp = Nhp or Nh
    m = jnp.arange(Nhp, dtype=jnp.int32).reshape(Nhp, 1)
    z = z0 + jnp.arange(Bz, dtype=jnp.int32).reshape(1, Bz)
    ang = (2.0 * jnp.pi / N) * jnp.asarray((m * z) % N, jnp.float32)
    w = jnp.where((m == 0) | (m == N // 2), 1.0, 2.0).astype(jnp.float32) / N
    w = jnp.where(m < Nh, w, 0.0)
    return ((w * jnp.cos(ang)).astype(dtype),
            (-w * jnp.sin(ang)).astype(dtype))


def _fzbases(N: int, z0, Bz: int, Nhp: int = None):
    """FORWARD rfft_z bases [Bz, Nhp] f32 (accumulating a spectrum from
    real z-slabs): W[z, kz] = exp(-2 pi i z kz / N), returned (cos, -sin)
    as separate f32 mats; zero columns past Nh (kz padding)."""
    Nh = N // 2 + 1
    Nhp = Nhp or Nh
    z = z0 + jnp.arange(Bz, dtype=jnp.int32).reshape(Bz, 1)
    m = jnp.arange(Nhp, dtype=jnp.int32).reshape(1, Nhp)
    ang = (2.0 * jnp.pi / N) * jnp.asarray((z * m) % N, jnp.float32)
    live = (m < Nh).astype(jnp.float32)
    return live * jnp.cos(ang), live * -jnp.sin(ang)


def _slab_matmul(ure, uim, C, S, prec):
    """Real z-slab of one component: ure/uim [N(x), Nh(kz), N(y)] ->
    [Bz, N, N].  The kz-contraction runs as a batched matmul over x with
    kz as the contracted middle axis, so each half transform is stored
    that way and read as a WHOLE array (slices of a stacked operand
    would materialize; module docstring)."""
    re = jnp.einsum("xky,kb->bxy", ure, C, precision=prec,
                    preferred_element_type=jnp.float32)
    im = jnp.einsum("xky,kb->bxy", uim, S, precision=prec,
                    preferred_element_type=jnp.float32)
    return re + im


def _consume6(us, C, S, prec):
    """The six Hessian z-slab fields from the flat 12-tuple us
    (re_c = us[2c], im_c = us[2c+1])."""
    return [_slab_matmul(us[2 * c], us[2 * c + 1], C, S, prec)
            for c in range(6)]


class OocEngine:
    """One out-of-core fmax run.  All jitted members are shaped by
    (N, Bkz, Bz, dtype) only, so every radius / source reuses the same
    executables.  Half-transform stacks are FLAT TUPLES of [N, Nh, N]
    arrays (12 for the Hessian, 6 for first derivatives, 2 for a single
    component); every member is one short per-batch program (module
    docstring)."""

    def __init__(self, params: Params, cosmo: Cosmology,
                 verbose: bool = True, mesh=None):
        """mesh: optional 1-D jax.sharding.Mesh — the half-transform
        stacks, source spectra, Fmax/q2 slab-row stores and the needed
        -index table shard over its axis (kz planes / z-slab rows), so
        grids beyond ONE chip's HBM ledger run on N chips' combined HBM
        (allocations.c per-task budget x decomposition, composed freely
        like the reference).  Compute partitioning is GSPMD: the slab
        matmuls' kz contraction becomes a partial dot + psum, builders
        write only the owning shard."""
        self.params = params
        self.cosmo = cosmo
        self.verbose = verbose
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            ax = mesh.axis_names[0]
            self.ndev = int(mesh.devices.size)
            self.shard_u = NamedSharding(mesh, PartitionSpec(None, ax,
                                                             None))
            self.shard_spec = NamedSharding(
                mesh, PartitionSpec(None, None, ax, None))
            self.shard_rows = NamedSharding(mesh, PartitionSpec(ax, None))
        else:
            self.ndev = 1
            self.shard_u = self.shard_spec = self.shard_rows = None
        self.grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
        N = self.N = self.grid.N
        self.Nh = N // 2 + 1
        # kz-axis padding: the sharded multi-chip ledger needs the kz
        # dimension divisible by the mesh (Nh = N/2+1 is odd); padded
        # planes carry zero basis weight everywhere
        self.Nhp = self.Nh if mesh is None \
            else -(-self.Nh // self.ndev) * self.ndev
        from .planner import ooc_storage_dtype
        self.dtype = jnp.dtype(ooc_storage_dtype(params, n_chips=self.ndev))
        # Fmax / q2 / wire store: float16 only next to bfloat16 storage
        # (the ledger that needed it is the memory-tight one)
        self.fdtype = (jnp.float16 if self.dtype == jnp.bfloat16
                       else jnp.float32)
        # f32 dots at full float32 precision (no TF32); bfloat16 storage
        # is already rounded, so its dots run at DEFAULT
        self.prec = (jax.lax.Precision.DEFAULT if self.dtype == jnp.bfloat16
                     else jax.lax.Precision.HIGHEST)
        tgt = params.ooc_kz_batch or (16 if N >= 256 else self.Nh)
        self.kz_sched = _kz_schedule(self.Nh, tgt)
        self.Bkz = self.kz_sched[0][1]
        self.Bz = params.ooc_z_batch \
            or _divisor_batch(N, 16 if N >= 256 else N)
        assert N % self.Bz == 0, "ooc_z_batch must divide GridSize"
        self.Bx = _divisor_batch(N, 32)
        # batches fused per dispatch (lax.fori_loop or unrolled sections
        # inside one jit): fewer, longer programs per phase
        self.group = params.ooc_group if params.ooc_group else 4
        # the spec-reading LPT groups UNROLL their K sections (a fori
        # would hoist a full copy of the resident source spectrum,
        # +2 GB at 1024^3); at N >= 1024 their section count stays at 4
        # even when a deeper cycle group is requested
        self.group_lpt = self.group if N < 1024 else min(self.group, 4)
        # the fold phase (build_pair + fold + spectra) runs before any
        # displacement stack exists, so deeper fusion fits there
        self.group_fold = min(2 * self.group, 8)
        # grouped v-row stream dispatches: [K, cap, 3] transfer buffers
        # scale with K x cap, so grouping stays off at N >= 1024
        self.group_rows = self.group if N < 1024 else 1
        self.plane = kdensity_plane_fn(self.grid, cosmo,
                                       params.RandomSeed,
                                       fixed=params.FixedIC,
                                       paired=params.PairedIC)
        self.sm = Smoothing.build(params, cosmo)
        self.timings: Dict[str, float] = {}

    def _filled(self, shape, dtype, sharding, fill=None):
        """Fresh device array, sharded over the mesh when one is set
        (and the sharded dim divides; uneven splits fall back to
        replicated — GSPMD still partitions the contractions)."""
        if fill is None:
            fn = partial(jnp.zeros, shape, dtype)
        else:
            fn = partial(jnp.full, shape, fill, dtype)
        if self.mesh is None or sharding is None:
            return fn()
        return jax.jit(fn, out_shardings=sharding)()

    def zeros_half(self, dtype=None):
        """One [N, Nhp, N] half-transform array (kz-sharded)."""
        return self._filled((self.N, self.Nhp, self.N),
                            dtype or self.dtype, self.shard_u)

    def zeros_stack(self, ncomp: int):
        """Fresh flat tuple of 2*ncomp half-transform arrays."""
        return tuple(self.zeros_half() for _ in range(2 * ncomp))

    def zeros_spec(self):
        """One [2, N, Nhp, N] source spectrum (kz-sharded)."""
        return self._filled((2, self.N, self.Nhp, self.N), self.dtype,
                            self.shard_spec)

    def _rows_sharding(self):
        nsl = self.N // self.Bz
        return self.shard_rows if nsl % self.ndev == 0 else None

    def full_rows(self, fill, dtype):
        """Slab-row dense store [nsl, Bz*N*N] (Fmax / q2), row-sharded
        when the slab count divides the mesh."""
        return self._filled((self.N // self.Bz, self.Bz * self.N ** 2),
                            dtype, self._rows_sharding(), fill=fill)

    def put_rows(self, arr):
        """Host [nsl, cap] table -> device, row-sharded like the
        slab-row stores."""
        sh = self._rows_sharding()
        if self.mesh is None or sh is None:
            return jax.device_put(arr)
        return jax.device_put(arr, sh)

    def put_dense(self, arr):
        """Host z-major [N, N, N] field -> device, sharded over z."""
        if self.mesh is None or arr.shape[0] % self.ndev:
            return jax.device_put(arr)
        from jax.sharding import NamedSharding, PartitionSpec
        ax = self.mesh.axis_names[0]
        return jax.device_put(
            arr, NamedSharding(self.mesh,
                               PartitionSpec(ax, None, None)))

    def _kxy(self):
        N = self.N
        half = N // 2
        ix = jnp.arange(N, dtype=jnp.int32)
        kx1 = (2.0 * jnp.pi / N) * jnp.where(ix <= half, ix, ix - N
                                             ).astype(jnp.float32)
        return kx1.reshape(N, 1), kx1.reshape(1, N)

    def _store_uc(self, out, idx, w, kz0):
        """Write the [B, N, N] c64 half-transform batch w into the
        (re, im) arrays out[idx], out[idx+1] at kz offset kz0
        ([B, N, N] -> [N(x), B(kz), N(y)])."""
        wre = jnp.transpose(jnp.real(w), (1, 0, 2)).astype(self.dtype)
        wim = jnp.transpose(jnp.imag(w), (1, 0, 2)).astype(self.dtype)
        out[idx] = jax.lax.dynamic_update_slice(out[idx], wre,
                                                (0, kz0, 0))
        out[idx + 1] = jax.lax.dynamic_update_slice(out[idx + 1], wim,
                                                    (0, kz0, 0))

    # ---------------- pass A: build half-transform stacks -------------

    def _facs_hessian(self, kxp, kyp, kzv, R_grid):
        """fac_c(k) for the 6 Hessian components at one kz batch:
        kxp [N,1], kyp [1,N] signed grid-unit k, kzv [B,1,1]."""
        k2 = kxp * kxp + kyp * kyp + kzv * kzv
        inv = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
        smooth = jnp.exp(-0.5 * k2 * R_grid * R_grid) * inv
        kvec = (kxp, kyp, kzv)
        return [(kvec[a] * kvec[b]) * smooth for a, b in PAIRS]

    def _read_spec(self, spec, kz0, B):
        """One kz batch of a resident spectrum [2, N, Nh, N] ->
        [B, N, N] c64 (small slice reads are alias-safe)."""
        N = self.N
        re = jax.lax.dynamic_slice(spec, (0, 0, kz0, 0), (1, N, B, N))[0]
        im = jax.lax.dynamic_slice(spec, (1, 0, kz0, 0), (1, N, B, N))[0]
        return jnp.transpose(re.astype(jnp.float32)
                             + 1j * im.astype(jnp.float32), (1, 0, 2))

    @partial(jax.jit, static_argnames=("self", "B"), donate_argnums=(1,))
    def build_hessian_batch(self, us, R_grid, kz0, B):
        """ONE kz batch of the 6 Hessian half-transforms (us: flat
        12-tuple, donated): ifft2(k_a k_b exp(-k^2 R^2/2)/k^2 * delta),
        delta regenerated per plane (no resident spectrum)."""
        kzs = kz0 + jnp.arange(B, dtype=jnp.int32)
        d = jax.vmap(self.plane)(kzs)          # [B, N, N] c64
        kxp, kyp = self._kxy()
        kzv = ((2.0 * jnp.pi / self.N)
               * kzs.astype(jnp.float32)).reshape(B, 1, 1)
        facs = self._facs_hessian(kxp, kyp, kzv, R_grid)
        out = list(us)
        for c in range(6):
            self._store_uc(out, 2 * c,
                           jnp.fft.ifft2(d * facs[c], axes=(1, 2)), kz0)
        return tuple(out)

    @partial(jax.jit, static_argnames=("self", "source", "B"),
             donate_argnums=(1,))
    def build_first_batch(self, us, spec, gtab, glo, gdx, kz0,
                          source: str, B: int):
        """ONE kz batch of the 3 first-derivative half-transforms
        i k_c / k^2 * g(|k|) (us: flat 6-tuple, donated).
        source='density': regenerate delta per plane (spec unused);
        source='spec': read planes of spec [2, N, Nh, N] (plain arg).
        g: per-|k| growth table over log10 k grid units (scale-dependent
        growth, fmax-pfft.c:344-364); a constant table gives scalar g."""
        kzs = kz0 + jnp.arange(B, dtype=jnp.int32)
        if source == "density":
            d = jax.vmap(self.plane)(kzs)
        else:
            d = self._read_spec(spec, kz0, B)
        kxp, kyp = self._kxy()
        kzv = ((2.0 * jnp.pi / self.N)
               * kzs.astype(jnp.float32)).reshape(B, 1, 1)
        k2 = kxp * kxp + kyp * kyp + kzv * kzv
        inv = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
        logk = 0.5 * jnp.log10(jnp.maximum(k2, 1e-12))
        t = jnp.clip((logk - glo) / gdx, 0.0, gtab.shape[0] - 1.001)
        it = t.astype(jnp.int32)
        wt = t - it.astype(jnp.float32)
        g = gtab[it] * (1.0 - wt) + gtab[it + 1] * wt
        base = d * (1j * (inv * g))
        out = list(us)
        for c, kc in enumerate((kxp, kyp, kzv)):
            self._store_uc(out, 2 * c,
                           jnp.fft.ifft2(base * kc, axes=(1, 2)), kz0)
        return tuple(out)

    @partial(jax.jit, static_argnames=("self", "B"),
             donate_argnums=(1, 2, 3, 4))
    def build_pair_batch(self, u1re, u1im, u2re, u2im, spec,
                         ia: jnp.int32, ib: jnp.int32,
                         fac_one: jnp.bool_, kz0, B: int = None):
        """ONE kz batch of BOTH 3LPT-b fold operands for one Hessian
        component k_ia k_ib / k^2: u1 from the DENSITY (regenerated) and
        u2 from the resident q2 spectrum (plain arg), sharing one fac
        evaluation — half the dispatches of building them separately.
        fac_one=True instead applies factor 1 (the 'first' fold call:
        trace term tr(phi,ij) = delta, and q2 itself).  Flags traced so
        the 6+1 combinations share one executable (LPT.c:89-141)."""
        N = self.N
        kzs = kz0 + jnp.arange(B, dtype=jnp.int32)
        d1 = jax.vmap(self.plane)(kzs)
        d2 = self._read_spec(spec, kz0, B)
        kxp, kyp = self._kxy()
        kzv = ((2.0 * jnp.pi / N)
               * kzs.astype(jnp.float32)).reshape(B, 1, 1)
        k2 = kxp * kxp + kyp * kyp + kzv * kzv
        inv = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
        kv = jnp.stack([jnp.broadcast_to(kxp, (B, N, N)),
                        jnp.broadcast_to(kyp, (B, N, N)),
                        jnp.broadcast_to(kzv, (B, N, N))])
        fac = jnp.where(fac_one, 1.0, kv[ia] * kv[ib] * inv)
        out = [u1re, u1im, u2re, u2im]
        for half, d in enumerate((d1, d2)):
            w = jnp.fft.ifft2(d * fac, axes=(1, 2))
            wre = jnp.transpose(jnp.real(w), (1, 0, 2)).astype(self.dtype)
            wim = jnp.transpose(jnp.imag(w), (1, 0, 2)).astype(self.dtype)
            out[2 * half] = jax.lax.dynamic_update_slice(
                out[2 * half], wre, (0, kz0, 0))
            out[2 * half + 1] = jax.lax.dynamic_update_slice(
                out[2 * half + 1], wim, (0, kz0, 0))
        return tuple(out)

    # ---------------- pass B: z-slab consumers -------------------------

    @partial(jax.jit, static_argnames=("self",), donate_argnums=(2, 3, 4))
    def cycle_slab(self, us, Fmax, s1, s2, pack, z0):
        """ONE z-slab of one collapse-cycle radius: Fmax and the delta
        moment accumulators (all donated) updated in place; us is read
        as plain arguments (module docstring).
        Rmax is not tracked — nothing in the catalog pipeline reads it
        (the sweep never does; fmax.py fetch_products_host docstring).
        Fmax is stored as SLAB ROWS [nsl, Bz*N*N] (z-major when
        reshaped): a contiguous row update leaves XLA no layout freedom
        — both a transposed [N, N, Bz] update and a 3-D z-major block
        update made the grouped 1024^3 program relayout-copy the whole
        2 GB grid (+0.6 GB over HBM, measured twice)."""
        N, Bz = self.N, self.Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        sd = _consume6(us, C, S, self.prec)
        delta = sd[0] + sd[1] + sd[2]
        l1, l2, l3, fail = collapse.eigenvalues_descending(sd)
        bc = collapse.ell_classic(l1, l2, l3)
        loga = collapse.eval_inverse_growth(
            pack, jnp.log10(jnp.maximum(bc, 1e-30)))
        F = jnp.where(bc > 0.0,
                      jnp.exp2(-3.321928094887362 * loga), 0.0)
        F = jnp.where(fail, -10.0, F)
        row = (z0 // Bz).astype(jnp.int32) if hasattr(z0, "astype") \
            else jnp.int32(z0 // Bz)
        Fsl = jax.lax.dynamic_slice(Fmax, (row, 0), (1, Bz * N * N))
        Fsl = jnp.maximum(Fsl, F.astype(self.fdtype).reshape(1, -1))
        Fmax = jax.lax.dynamic_update_slice(Fmax, Fsl, (row, 0))
        m1 = jnp.mean(jnp.mean(jnp.mean(delta, -1), -1))
        m2 = jnp.mean(jnp.mean(jnp.mean(delta * delta, -1), -1))
        return Fmax, s1 + m1, s2 + m2

    @partial(jax.jit, static_argnames=("self", "interp"),
             donate_argnums=(2, 3, 4))
    def cycle_slab_tab(self, us, Fmax, s1, s2, tab, tab2, dv, idx_map,
                       ampl, z0, interp: str = "trilinear"):
        """cycle_slab variant for TABULATED_CT / ELL_SNG: F from
        interpolation of the per-radius collapse-time table in the chosen
        variant (interpolate_collapse_time, collapse_times.c:1139-1231;
        the monolithic analog is collapse.collapse_update_table)."""
        from .ops import tabulated
        N, Bz = self.N, self.Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        sd = _consume6(us, C, S, self.prec)
        delta = sd[0] + sd[1] + sd[2]
        l1, l2, l3, fail = collapse.eigenvalues_descending(sd)
        F = tabulated.interp_F(interp, tab, tab2, dv, idx_map, ampl,
                               l1, l2, l3)
        F = jnp.where(fail, -10.0, F)
        row = jnp.int32(z0 // Bz) if not hasattr(z0, "astype") \
            else (z0 // Bz).astype(jnp.int32)
        Fsl = jax.lax.dynamic_slice(Fmax, (row, 0), (1, Bz * N * N))
        Fsl = jnp.maximum(Fsl, F.astype(self.fdtype).reshape(1, -1))
        Fmax = jax.lax.dynamic_update_slice(Fmax, Fsl, (row, 0))
        m1 = jnp.mean(jnp.mean(jnp.mean(delta, -1), -1))
        m2 = jnp.mean(jnp.mean(jnp.mean(delta * delta, -1), -1))
        return Fmax, s1 + m1, s2 + m2

    @partial(jax.jit, static_argnames=("self",), donate_argnums=(2,))
    def q2_slab(self, us, q2, z0):
        """ONE z-slab of the 2LPT source from the R=0 Hessian stack us,
        written DENSE on device [N, N, N] in the WIRE dtype (fdtype),
        Z-MAJOR like Fmax (contiguous leading-axis slab updates, no
        transpose/relayout; LPT.c:70-76).  The caller donates the
        retired Fmax buffer as q2's storage — same shape + dtype, so it
        aliases and the 2LPT phase allocates NOTHING (module ledger)."""
        N, Bz = self.N, self.Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        sd = _consume6(us, C, S, self.prec)
        xx, yy, zz, xy, xz, yz = sd
        src2 = (xx * yy + xx * zz + yy * zz
                - xy * xy - xz * xz - yz * yz)
        row = jnp.int32(z0 // Bz) if not hasattr(z0, "astype") \
            else (z0 // Bz).astype(jnp.int32)
        return jax.lax.dynamic_update_slice(
            q2, src2.astype(self.fdtype).reshape(1, -1), (row, 0))

    @partial(jax.jit, static_argnames=("self",))
    def q31_slab(self, us, z0):
        """One z-slab of the 3LPT-a source 3*det(phi,ij) (LPT.c:79-87),
        [Bz, N, N] in the wire dtype — the dense field round-trips
        through the HOST because no third N^3 device buffer fits next to
        us + q2 at 1024^3 (module ledger)."""
        N, Bz = self.N, self.Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        sd = _consume6(us, C, S, self.prec)
        xx, yy, zz, xy, xz, yz = sd
        src31 = 3.0 * (xx * (yy * zz - yz * yz)
                       - xy * (xy * zz - xz * yz)
                       + xz * (xy * yz - xz * yy))
        # [Bz, N, N] z-major: the host concatenates along axis 0
        return src31.astype(self.fdtype)

    @partial(jax.jit, static_argnames=("self",), donate_argnums=(5, 6))
    def fold_slab(self, u1re, u1im, u2re, u2im, wre, wim,
                  first: jnp.bool_, weight, z0):
        """ONE z-slab of one component-pair of the 3LPT-b source,
        accumulated DIRECTLY in its forward-z spectrum (wre, wim)
        [N, Nh, N] f32 (donated — SEPARATE re/im arrays so each add
        aliases in place; a stacked [2, ...] accumulator cost a 4 GiB
        stack temp at 1024^3):
          contribution(x) = first ? 2*tr(sd)*q2(x) : 0  - 2*w*phi2_c*phi1_c
        where on the 'first' call u1/u2 are the TRACE half-transform of
        sd and the q2 half-transform (LPT.c:89-141)."""
        N, Bz = self.N, self.Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        a = _slab_matmul(u1re, u1im, C, S, self.prec)
        b = _slab_matmul(u2re, u2im, C, S, self.prec)
        contrib = jnp.where(first, 2.0 * a * b,
                            -2.0 * weight * a * b)
        FC, FS = _fzbases(N, z0, Bz, self.Nhp)
        wre = wre + jnp.einsum("bxy,bk->xky", contrib, FC,
                               precision=self.prec,
                               preferred_element_type=jnp.float32)
        wim = wim + jnp.einsum("bxy,bk->xky", contrib, FS,
                               precision=self.prec,
                               preferred_element_type=jnp.float32)
        return wre, wim

    # ---------------- forward transforms (host fields -> spectra) -----

    @partial(jax.jit, static_argnames=("self",), donate_argnums=(2,))
    def rfftz_batch(self, q, out, x0):
        """ONE x batch of the forward z-transform of a dense real field
        q (slab rows [nsl, Bz*N*N] or z-major [N, N, N]; plain arg)
        into the spectrum layout out [2, N, Nhp, N] (donated): an rfft
        over z, kz padded to Nhp with zero planes."""
        N, Nh, Bx = self.N, self.Nh, self.Bx
        q3 = jnp.reshape(q, (N, N, N))            # z-major view
        sl = jax.lax.dynamic_slice(q3, (0, x0, 0),
                                   (N, Bx, N)).astype(jnp.float32)
        w = jnp.transpose(jnp.fft.rfft(sl, axis=0), (1, 0, 2))  # [Bx,Nh,N]
        w = jnp.pad(w, ((0, 0), (0, self.Nhp - Nh), (0, 0)))
        blk = jnp.stack([jnp.real(w), jnp.imag(w)]).astype(out.dtype)
        return jax.lax.dynamic_update_slice(out, blk, (0, x0, 0, 0))

    @partial(jax.jit, static_argnames=("self", "B"), donate_argnums=(1,))
    def fft2_batch(self, w, kz0, B):
        """ONE kz batch of the forward (x, y) fft2 finishing a spectrum
        in place on w [2, N, Nh, N] (donated).  Batches MUST be disjoint
        (in-place transform)."""
        N = self.N
        re = jax.lax.dynamic_slice(w, (0, 0, kz0, 0), (1, N, B, N))[0]
        im = jax.lax.dynamic_slice(w, (1, 0, kz0, 0), (1, N, B, N))[0]
        f = jnp.fft.fft2(re.astype(jnp.float32)
                         + 1j * im.astype(jnp.float32), axes=(0, 2))
        blk = jnp.stack([jnp.real(f), jnp.imag(f)]).astype(w.dtype)
        return jax.lax.dynamic_update_slice(w, blk, (0, 0, kz0, 0))

    @partial(jax.jit, static_argnames=("self", "B"), donate_argnums=(3,))
    def fft2_pair_batch(self, wre, wim, out, kz0, B):
        """ONE kz batch of the forward (x, y) fft2 of the fold
        accumulators (separate f32 re/im [N, Nh, N], plain args) into
        the store-dtype spectrum out [2, N, Nh, N] (donated)."""
        N = self.N
        re = jax.lax.dynamic_slice(wre, (0, kz0, 0), (N, B, N))
        im = jax.lax.dynamic_slice(wim, (0, kz0, 0), (N, B, N))
        f = jnp.fft.fft2(re + 1j * im, axes=(0, 2))
        blk = jnp.stack([jnp.real(f), jnp.imag(f)]).astype(out.dtype)
        return jax.lax.dynamic_update_slice(out, blk, (0, 0, kz0, 0))

    # ---------------- grouped dispatches -------------------------------
    # K consecutive batches fused into ONE device program (fewer
    # dispatches per phase).  Only the DENSITY-sourced Hessian builder may use a
    # lax.fori_loop — its carried stacks are only WRITTEN
    # (dynamic_update_slice aliases in place) and its dots read
    # fresh-per-iteration operands.  Every member whose dots READ a big
    # resident array (the cycle/fold consumers reading the stacks, the
    # LPT builders reading a source spectrum) must NOT: a dot reading it
    # from loop context makes XLA materialize a FULL COPY (+12.45 GiB
    # measured at 1024^3 in cycle_group's compile — the r3 hoist, which
    # hits loop-INVARIANT reads too), so those groups UNROLL the K
    # iterations into straight-line XLA where reads alias like the
    # per-batch programs.

    @partial(jax.jit, static_argnames=("self", "B", "K"),
             donate_argnums=(1,))
    def build_hessian_group(self, us, R_grid, kz00, B: int, K: int):
        body = type(self).build_hessian_batch.__wrapped__

        def step(i, us):
            return body(self, us, R_grid, kz00 + i * B, B)
        return jax.lax.fori_loop(0, K, step, us)

    @partial(jax.jit, static_argnames=("self", "source", "B", "K"),
             donate_argnums=(1,))
    def build_first_group(self, us, spec, gtab, glo, gdx, kz00,
                          source: str, B: int, K: int):
        """UNROLLED (not fori): a dot reading the resident spectrum from
        loop context makes XLA hoist a full copy of it (+2 GB at 1024^3
        — the round-4 v-stream ResourceExhausted); straight-line
        sections read it aliased like the per-batch programs."""
        body = type(self).build_first_batch.__wrapped__
        tok = jnp.int32(0)
        for i in range(K):
            us = body(self, us, spec, gtab, glo, gdx,
                      kz00 + i * B + tok, source, B)
            (spec,), us = _seq((spec,), tuple(us), i, K)
            # the barrier alone orders only the SPEC reads; the per
            # -section plane regeneration + ifft2 read nothing carried,
            # so XLA co-scheduled all K sections' [B, N, N] c64
            # transients (+~2 GB — the round-5 v-stream
            # ResourceExhausted).  A zero token read from the carried
            # stack makes section i+1's kz indices depend on section i.
            tok = (us[0][0, 0, 0] * 0).astype(jnp.int32)
        return us

    @partial(jax.jit, static_argnames=("self", "B", "K"),
             donate_argnums=(1, 2, 3, 4))
    def build_pair_group(self, u1re, u1im, u2re, u2im, spec, ia, ib,
                         fac_one, kz00, B: int, K: int):
        """UNROLLED for the same spec-hoist reason as
        build_first_group."""
        body = type(self).build_pair_batch.__wrapped__
        uu = (u1re, u1im, u2re, u2im)
        tok = jnp.int32(0)
        for i in range(K):
            uu = body(self, *uu, spec, ia, ib, fac_one,
                      kz00 + i * B + tok, B)
            (spec,), uu = _seq((spec,), tuple(uu), i, K)
            # serialize the density-sourced half too (see
            # build_first_group)
            tok = (uu[0][0, 0, 0] * 0).astype(jnp.int32)
        return uu

    @partial(jax.jit, static_argnames=("self", "K"),
             donate_argnums=(2, 3, 4))
    def cycle_group(self, us, Fmax, s1, s2, pack, z00, K: int):
        body = type(self).cycle_slab.__wrapped__
        for j in range(K):                 # UNROLLED: us dot-reads alias
            Fmax, s1, s2 = body(self, us, Fmax, s1, s2, pack,
                                z00 + j * self.Bz)
            us, (Fmax, s1, s2) = _seq(us, (Fmax, s1, s2), j, K)
        return Fmax, s1, s2

    @partial(jax.jit, static_argnames=("self", "interp", "K"),
             donate_argnums=(2, 3, 4))
    def cycle_tab_group(self, us, Fmax, s1, s2, tab, tab2, dv, idx_map,
                        ampl, z00, interp: str, K: int):
        body = type(self).cycle_slab_tab.__wrapped__
        for j in range(K):
            Fmax, s1, s2 = body(self, us, Fmax, s1, s2, tab, tab2, dv,
                                idx_map, ampl, z00 + j * self.Bz, interp)
            us, (Fmax, s1, s2) = _seq(us, (Fmax, s1, s2), j, K)
        return Fmax, s1, s2

    @partial(jax.jit, static_argnames=("self", "K"), donate_argnums=(2,))
    def q2_group(self, us, q2, z00, K: int):
        body = type(self).q2_slab.__wrapped__
        for j in range(K):
            q2 = body(self, us, q2, z00 + j * self.Bz)
            us, (q2,) = _seq(us, (q2,), j, K)
        return q2

    @partial(jax.jit, static_argnames=("self", "K"),
             donate_argnums=(5, 6))
    def fold_group(self, u1re, u1im, u2re, u2im, wre, wim, first,
                   weight, z00, K: int):
        body = type(self).fold_slab.__wrapped__
        uu = (u1re, u1im, u2re, u2im)
        for j in range(K):
            wre, wim = body(self, *uu, wre, wim, first, weight,
                            z00 + j * self.Bz)
            uu, (wre, wim) = _seq(uu, (wre, wim), j, K)
        return wre, wim

    @partial(jax.jit, static_argnames=("self", "K"), donate_argnums=(2,))
    def rfftz_group(self, q, out, x00, K: int):
        body = type(self).rfftz_batch.__wrapped__
        for i in range(K):
            out = body(self, q, out, x00 + i * self.Bx)
        return out

    @partial(jax.jit, static_argnames=("self", "B", "K"),
             donate_argnums=(1,))
    def fft2_group(self, w, kz00, B: int, K: int):
        body = type(self).fft2_batch.__wrapped__
        for i in range(K):
            w = body(self, w, kz00 + i * B, B)
        return w

    @partial(jax.jit, static_argnames=("self", "B", "K"),
             donate_argnums=(3,))
    def fft2_pair_group(self, wre, wim, out, kz00, B: int, K: int):
        body = type(self).fft2_pair_batch.__wrapped__
        for i in range(K):
            out = body(self, wre, wim, out, kz00 + i * B, B)
        return out

    # ---------------- python-loop drivers ------------------------------

    def _kz_chunks(self, group=None):
        """(kz0, B, K) chunks: full-size batches grouped K at a time,
        the remainder batch on its own (at most 3 distinct executables
        per member: K-group, tail group, remainder)."""
        g = self.group if group is None else group
        full = [s for s in self.kz_sched if s[1] == self.Bkz]
        out = []
        i = 0
        while i < len(full):
            k = min(g, len(full) - i)
            out.append((full[i][0], self.Bkz, k))
            i += k
        for kz0, B in self.kz_sched[len(full):]:
            out.append((kz0, B, 1))
        return out

    def _z_chunks(self, group=None):
        g = self.group if group is None else group
        nsl = self.N // self.Bz
        out = []
        j = 0
        while j < nsl:
            k = min(g, nsl - j)
            out.append((j * self.Bz, k))
            j += k
        return out

    def build_hessian(self, us, R_grid):
        for kz0, B, K in self._kz_chunks():
            if K == 1:
                us = self.build_hessian_batch(us, R_grid, jnp.int32(kz0),
                                              B=B)
            else:
                us = self.build_hessian_group(us, R_grid, jnp.int32(kz0),
                                              B=B, K=K)
        return us

    def build_first(self, us, spec, g, source):
        for kz0, B, K in self._kz_chunks(self.group_lpt):
            if K == 1:
                us = self.build_first_batch(us, spec, *g, jnp.int32(kz0),
                                            source=source, B=B)
            else:
                us = self.build_first_group(us, spec, *g, jnp.int32(kz0),
                                            source=source, B=B, K=K)
        return us

    def build_pair(self, uu, spec, ia, ib, fac_one):
        """uu = (u1re, u1im, u2re, u2im): both fold operands for one
        component over all kz batches."""
        args = (jnp.int32(ia), jnp.int32(ib), jnp.bool_(fac_one))
        for kz0, B, K in self._kz_chunks(self.group_fold):
            if K == 1:
                uu = self.build_pair_batch(*uu, spec, *args,
                                           jnp.int32(kz0), B=B)
            else:
                uu = self.build_pair_group(*uu, spec, *args,
                                           jnp.int32(kz0), B=B, K=K)
        return uu

    def cycle_radius(self, us, Fmax, s1, s2, pack):
        """One radius of the collapse cycle over all z-slabs."""
        for z0, K in self._z_chunks():
            if K == 1:
                Fmax, s1, s2 = self.cycle_slab(us, Fmax, s1, s2, pack,
                                               jnp.int32(z0))
            else:
                Fmax, s1, s2 = self.cycle_group(us, Fmax, s1, s2, pack,
                                                jnp.int32(z0), K=K)
        return Fmax, s1, s2

    def cycle_radius_tab(self, us, Fmax, s1, s2, tab, tab2, dv, idx_map,
                         ampl, interp):
        for z0, K in self._z_chunks():
            if K == 1:
                Fmax, s1, s2 = self.cycle_slab_tab(
                    us, Fmax, s1, s2, tab, tab2, dv, idx_map, ampl,
                    jnp.int32(z0), interp=interp)
            else:
                Fmax, s1, s2 = self.cycle_tab_group(
                    us, Fmax, s1, s2, tab, tab2, dv, idx_map, ampl,
                    jnp.int32(z0), interp=interp, K=K)
        return Fmax, s1, s2

    def q2_all(self, us, q2):
        for z0, K in self._z_chunks(self.group_lpt):
            q2 = (self.q2_slab(us, q2, jnp.int32(z0)) if K == 1
                  else self.q2_group(us, q2, jnp.int32(z0), K=K))
        return q2

    def fold_pair(self, wre, wim, u1re, u1im, u2re, u2im, first, weight):
        for z0, K in self._z_chunks(self.group_fold):
            if K == 1:
                wre, wim = self.fold_slab(u1re, u1im, u2re, u2im,
                                          wre, wim, first, weight,
                                          jnp.int32(z0))
            else:
                wre, wim = self.fold_group(u1re, u1im, u2re, u2im,
                                           wre, wim, first, weight,
                                           jnp.int32(z0), K=K)
        return wre, wim

    def to_spec(self, q, out):
        """Dense real field [N, N, N] (z minor, plain arg) -> spectrum
        [2, N, Nh, N] (donated out, store dtype): rfft over z in
        x-batches, then fft2 per kz batch — the staged forward
        counterpart of pass A."""
        nbx = self.N // self.Bx
        i = 0
        while i < nbx:
            k = min(self.group_fold, nbx - i)
            if k == 1:
                out = self.rfftz_batch(q, out, jnp.int32(i * self.Bx))
            else:
                out = self.rfftz_group(q, out, jnp.int32(i * self.Bx),
                                       K=k)
            i += k
        for kz0, B, K in self._kz_chunks(self.group_fold):
            out = (self.fft2_batch(out, jnp.int32(kz0), B=B) if K == 1
                   else self.fft2_group(out, jnp.int32(kz0), B=B, K=K))
        return out

    def pair_to_spec(self, wre, wim, out):
        """Fold accumulators (f32 re/im pair) -> store-dtype spectrum."""
        for kz0, B, K in self._kz_chunks(self.group_fold):
            out = (self.fft2_pair_batch(wre, wim, out, jnp.int32(kz0),
                                        B=B) if K == 1
                   else self.fft2_pair_group(wre, wim, out,
                                             jnp.int32(kz0), B=B, K=K))
        return out

    # ---------------- needed-row gather -------------------------------

    @partial(jax.jit, static_argnames=("self",))
    def vrows_slab(self, us, idx_all, j):
        """Needed rows of one displacement stack for z-slab j: us (flat
        6-tuple) -> gather rows [cap, 3] wire-dtype via idx_all[j]
        (int32 indices into the slab's [Bz, N, N] C-order flattening;
        padded tail rows are junk the host drops)."""
        N, Bz = self.N, self.Bz
        cap = idx_all.shape[1]
        idx = jax.lax.dynamic_slice(idx_all, (j, 0), (1, cap))[0]
        z0 = j * Bz
        C, S = _zbases(N, z0, Bz, self.dtype, self.Nhp)
        comps = [_slab_matmul(us[2 * c], us[2 * c + 1], C, S,
                              self.prec).reshape(-1)
                 for c in range(3)]
        rows = jnp.stack([c[idx] for c in comps], axis=1)
        return rows.astype(self.fdtype)

    @partial(jax.jit, static_argnames=("self", "K"))
    def vrows_group(self, us, idx_all, j0, K: int):
        """K consecutive slabs' needed rows in one dispatch
        [K, cap, 3]: same bytes on the wire, K x fewer round trips
        (K and the in-flight depth sized by the ledger — group_rows)."""
        body = type(self).vrows_slab.__wrapped__
        rows = []
        for j in range(K):
            rows.append(body(self, us, idx_all, j0 + j))
            us, (rows[-1],) = _seq(us, (rows[-1],), j, K)
        return jnp.stack(rows)

    @partial(jax.jit, static_argnames=("self", "K"))
    def q31_group(self, us, z00, K: int):
        """K consecutive 3LPT-a source slabs in one dispatch
        [K*Bz, N, N] (z-major, ready for the host concatenation)."""
        body = type(self).q31_slab.__wrapped__
        slabs = []
        for j in range(K):
            slabs.append(body(self, us, z00 + j * self.Bz))
            us, (slabs[-1],) = _seq(us, (slabs[-1],), j, K)
        return jnp.concatenate(slabs, axis=0)


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------

def _const_gtab(D: float):
    """Constant growth 'table' (scale-independent growth as the
    degenerate case of the per-|k| lookup)."""
    return (jnp.asarray([D, D], jnp.float32), jnp.float32(0.0),
            jnp.float32(1.0))


def ooc_supported(params: Params, reason: bool = False):
    """Which configurations the out-of-core engine covers: all collapse
    models (ELL_CLASSIC / TABULATED_CT / ELL_SNG), scale-dependent
    growth, RECOMPUTE_DISPLACEMENTS segments (extra per-segment row
    streams over the same resident spectra) and DumpProducts (the
    sparse rows are checkpointed once the streams land, io/dumps.py);
    only the timeless snapshot — whose writer reads UNCOLLAPSED
    particles too and therefore dense stacks — keeps the monolithic
    engine."""
    why = None
    if params.WriteTimelessSnapshot:
        why = "ooc engine keeps no dense displacement stacks for snapshots"
    return (why is None, why) if reason else why is None


class _OocStream:
    """Watermark-bearing host buffers for the ooc displacement streams.

    Duck-types fmax._StreamState for the fragmentation driver (.ready /
    .buffer / .wait / .check / .buffers) so StreamingVel and the C
    sweep's rows_ready consumer work unchanged.  Rows land in z-slab
    (storage) order while the sweep processes in descending-F order, so
    the watermark mostly gates the sweeps until the LAST table
    completes — the overlap win is that every sub-box's
    selection + sort (fragment.c:484-520, 580 s of dead serial time at
    1024^3) and the host needed-prep run DURING the streams instead of
    after them."""

    def __init__(self, n: int, keys):
        import threading
        self.n = n
        self.keys = list(keys)
        self.buffers: Dict[str, np.ndarray] = {}
        self._delivered = {k: 0 for k in self.keys}
        self._events = {k: threading.Event() for k in self.keys}
        self.ready = np.zeros(1, np.int64)
        self._lock = threading.Lock()
        self.error = None

    def buffer(self, key):
        with self._lock:
            b = self.buffers.get(key)
            if b is None:
                b = self.buffers[key] = np.empty((self.n, 3), np.float32)
        return b

    def advance(self, key, nrows: int):
        """Slab landings are FIFO per table, so nrows is the table's
        contiguous delivered prefix; the C sweep reads the min across
        tables (groupsweep.c rows_ready)."""
        with self._lock:
            self._delivered[key] = nrows
            self.ready[0] = min(self._delivered.values())
            if nrows >= self.n:
                self._events[key].set()

    def fail(self, err):
        self.error = err
        with self._lock:
            # unblock the sweep; consumers re-raise through check()
            self.ready[0] = self.n
            for ev in self._events.values():
                ev.set()

    def wait(self, key):
        self._events[key].wait()
        if self.error:
            raise self.error

    def check(self):
        if self.error:
            raise self.error


class _OocPending:
    """Handle for the ooc engine's in-flight background LPT phase: the
    pipeline driver join()s it AFTER fragmentation (the sweeps gate on
    the stream watermark anyway) to surface errors and the final
    sources/lpt timings."""

    def __init__(self, thread, stream, timings):
        self.thread = thread
        self.stream = stream
        self.timings = timings

    def join(self):
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.stream is not None:
            self.stream.check()
        return self.timings


def run_fmax_ooc(params: Params, cosmo: Cosmology, scaledep_gm=None,
                 verbose: bool = True, overlap: bool = True,
                 mesh=None) -> FmaxResult:
    """The out-of-core fmax run: collapse cycle + 3LPT displacements with
    a bounded device working set, host products assembled streaming.

    Covers every collapse model: ELL_CLASSIC via the per-radius
    inverse-growth packs, TABULATED_CT / ELL_SNG via the per-radius
    collapse-time tables (~1 MB each — they ride next to the
    half-transform stacks for free), and scale-dependent growth via
    per-radius packs (cycle) + per-mode D(k) tables (LPT streams).

    overlap=True (default): returns as soon as the needed-particle set
    (ci, F) is known — the source/fold/stream device phases continue on
    a background thread, landing displacement rows into watermarked
    host buffers (_OocStream), so fragmentation's selection+sort runs
    concurrently with them and the C sweeps start the moment the last
    table lands (rows_ready).  The caller must join
    FmaxResult.ooc_pending after fragmentation (run_pipeline does).

    Returns an FmaxResult whose host_products rows are in z-slab
    storage order (sorted_by='ci'): fragmentation sorts per sub-box on
    the host, since a device-side (-F) sort of N^3 >= 1024^3 keys has
    no workspace."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    ok, why = ooc_supported(params, reason=True)
    if not ok:
        raise ValueError(f"out-of-core fmax: {why} "
                         "(run the monolithic engine or drop the flag)")

    eng = OocEngine(params, cosmo, verbose=verbose, mesh=mesh)
    N, Nh = eng.N, eng.Nh
    nsl = N // eng.Bz
    sm = eng.sm
    timings: Dict[str, float] = {}
    ex = ThreadPoolExecutor(max_workers=2)   # d2h row streams

    # ---- collapse cycle --------------------------------------------
    t0 = time.perf_counter()
    radii_grid = sm.radii / eng.grid.CellSize
    tabulated_ct = params.ell_model != "classic"
    if tabulated_ct:
        from .fmax import prepare_ct_tables
        ct = prepare_ct_tables(params, cosmo, sm, verbose=verbose)
        ct_dv = jnp.asarray(ct["dv"])
        ct_idx = jnp.asarray(ct["idx_map"])
        ct_tab2s = np.asarray(ct["tables2"])
    else:
        packs = inverse_growth_packs(cosmo, sm, scaledep_gm)
    us = eng.zeros_stack(6)
    # slab-row store [nsl, Bz*N*N] (cycle_slab docstring)
    Fmax = eng.full_rows(-10.0, eng.fdtype)
    stats = []
    for ism in range(sm.n):
        us = eng.build_hessian(us, jnp.float32(radii_grid[ism]))
        if tabulated_ct:
            tab = jnp.asarray(ct["tables"][ism])
            tab2 = jnp.asarray(ct_tab2s[ism])
            ampl = jnp.float32(ct["ampl"][ism])
        else:
            pack = jnp.asarray(packs[ism])
        s1, s2 = jnp.float32(0.0), jnp.float32(0.0)
        if tabulated_ct:
            Fmax, s1, s2 = eng.cycle_radius_tab(
                us, Fmax, s1, s2, tab, tab2, ct_dv, ct_idx, ampl,
                params.ct_interp)
        else:
            Fmax, s1, s2 = eng.cycle_radius(us, Fmax, s1, s2, pack)
        stats.append((s1, s2))
    for ism, (m1, m2) in enumerate(stats):
        # syncs the cycle; the per-slab loop accumulates SUMS of slab
        # means, so normalize by the slab count here
        sm.true_variance[ism] = float(np.asarray(m2)) / nsl
        if verbose:
            print(f"  smoothing {ism + 1}/{sm.n}: "
                  f"R={sm.radii[ism]:9.5f} expected sigma "
                  f"{math.sqrt(sm.variance[ism]):7.4f} computed "
                  f"{math.sqrt(max(sm.true_variance[ism], 0.0)):7.4f}",
                  flush=True)
    timings["fmax_loop"] = time.perf_counter() - t0

    # ---- Fmax to host (must COMPLETE before q2 aliases its buffer) --
    t0 = time.perf_counter()
    F_host = np.asarray(Fmax).reshape(N, N, N)    # z-major [z, x, y]
    timings["fmax_transfer"] = time.perf_counter() - t0

    # ---- needed-cell prep + FmaxPDF, background host thread ---------
    # pure numpy over F_host: fully overlapped with the device-bound
    # source/fold phases (it was 300 s of dead serial time at 1024^3).
    # F_host is Z-MAJOR so every slab is a contiguous block
    prep: dict = {}

    def needed_prep():
        try:
            tp = time.perf_counter()
            flast = np.asarray(params.Flast, F_host.dtype)
            Bz = eng.Bz
            loc_idx, ci_parts, f_parts, counts = [], [], [], []
            hist = np.zeros(210, np.int64)
            for j in range(nsl):
                z0 = j * Bz
                blk = F_host[z0:z0 + Bz].reshape(-1)
                # FmaxPDF histogram in the same cache-warm pass
                # (fmax.c:509-550; f16 overflow handling as fmax_pdf)
                xb = blk.astype(np.float32) * 10.0
                xb = np.clip(np.nan_to_num(xb, nan=0.0, posinf=209.0,
                                           neginf=0.0).astype(np.int32),
                             0, 209)
                hist += np.bincount(xb, minlength=210)
                del xb
                li = np.flatnonzero(blk >= flast).astype(np.int32)
                loc_idx.append(li)
                counts.append(len(li))
                li64 = li.astype(np.int64)
                b, rem = np.divmod(li64, N * N)
                x, y = np.divmod(rem, N)
                ci_parts.append((x * N + y) * N + (z0 + b))
                f_parts.append(blk[li].astype(np.float32))
            ci_all = np.concatenate(ci_parts)
            F_all = np.concatenate(f_parts)
            del ci_parts, f_parts
            cap = max(128, int(-(-max(counts) * 1.02 // 128)) * 128)
            idx_pad = np.zeros((nsl, cap), np.int32)
            for j, li in enumerate(loc_idx):
                idx_pad[j, :len(li)] = li
            offsets = np.concatenate([[0],
                                      np.cumsum(counts)]).astype(np.int64)
            prep.update(ci=ci_all, F=F_all, counts=counts,
                        offsets=offsets, idx_pad=idx_pad, cap=cap,
                        ntot=len(ci_all), hist=hist)
            timings["needed_prep"] = time.perf_counter() - tp
        except BaseException as e:                     # noqa: BLE001
            prep["error"] = e

    prep_th = threading.Thread(target=needed_prep, daemon=True)
    prep_th.start()

    stream_ready = threading.Event()
    box: dict = {}
    base_keys = ["v1"]
    if params.lpt_order >= 2:
        base_keys.append("v2")
    if params.lpt_order >= 3:
        base_keys += ["v31", "v32"]
    # RECOMPUTE_DISPLACEMENTS: one extra displacement set per additional
    # output redshift (compute_displacements per segment,
    # fragment.c:398-429) — each is four more row streams over the SAME
    # resident source spectra
    multi_seg = (params.recompute_displacements
                 and len(params.output_z) > 1)
    lpt_keys = list(base_keys)
    if multi_seg:
        for s in range(1, len(params.output_z)):
            lpt_keys += [("seg", s, k) for k in base_keys]

    # ---- device phases: sources, folds, spectra, row streams --------
    def lpt_phase():
        nonlocal us, Fmax
        try:
            ts = time.perf_counter()
            lpt_order = params.lpt_order
            q2 = None
            if lpt_order >= 2:
                # q2 is stored in the wire dtype so the retired Fmax
                # buffer (same shape + dtype) aliases as its storage:
                # the 2LPT phase fits next to the 12-array us stack
                # without a fresh N^3 alloc
                q2, Fmax = Fmax, None
                q2 = eng.q2_all(us, q2)
            Fmax = None
            q31_parts = []
            if lpt_order >= 3:
                futs = []
                for z0, K in eng._z_chunks(eng.group_lpt):
                    sl = (eng.q31_slab(us, jnp.int32(z0)) if K == 1
                          else eng.q31_group(us, jnp.int32(z0), K=K))
                    futs.append(ex.submit(np.asarray, sl))
                    while len([f for f in futs if not f.done()]) > 3:
                        time.sleep(0.005)
                q31_parts = [f.result() for f in futs]
            us = None                     # free the Hessian stack
            timings["sources"] = time.perf_counter() - ts

            ts = time.perf_counter()
            # recompute runs evaluate the main set at the FIRST output
            # (fragment interpolates between segments; fmax.c z0 choice)
            z0out = (params.zlast if not params.recompute_displacements
                     else params.output_z[0])
            order_fns = (cosmo.GrowingMode, cosmo.GrowingMode_2LPT,
                         cosmo.GrowingMode_3LPT_1, cosmo.GrowingMode_3LPT_2)
            if getattr(cosmo, "scale_dep", False):
                # per-mode D_i(z, k) tables over log10 |k| grid units —
                # exactly the lookup build_first_batch implements
                # (fmax-pfft.c:344-364); cached per segment redshift
                from .fmax import growth_k_tables
                _gcache: dict = {}

                def growth(iorder, z):
                    if z not in _gcache:
                        _gcache[z] = growth_k_tables(cosmo, z, N)
                    gtabs, glo, gdx = _gcache[z]
                    return (gtabs[iorder], glo, gdx)
            else:
                def growth(iorder, z):
                    return _const_gtab(float(order_fns[iorder](z)))

            q2hat = None
            if lpt_order >= 2:
                q2hat = eng.to_spec(q2, eng.zeros_spec())
                q2 = None

            q32hat = None
            if lpt_order >= 3:
                # 3LPT-b: fold the mixed invariant one component-pair at
                # a time.  Runs while NO displacement stack exists — the
                # f32 re/im accumulators (4 GiB at 1024^3) + the two
                # component pairs + q2hat is the phase peak.
                wre = eng.zeros_half(jnp.float32)
                wim = eng.zeros_half(jnp.float32)
                uu = tuple(eng.zeros_half() for _ in range(4))
                uu = eng.build_pair(uu, q2hat, 0, 0, True)
                wre, wim = eng.fold_pair(wre, wim, *uu, np.bool_(True),
                                         np.float32(0.0))
                for c, (ia, ib) in enumerate(PAIRS):
                    uu = eng.build_pair(uu, q2hat, ia, ib, False)
                    wre, wim = eng.fold_pair(wre, wim, *uu,
                                             np.bool_(False),
                                             np.float32(PAIR_W[c]))
                uu = None
                q32hat = eng.pair_to_spec(wre, wim, eng.zeros_spec())
                wre = wim = None

            q31hat = None
            if lpt_order >= 3:
                # 3LPT-a: det source round-trips via the host
                q31h = np.concatenate(q31_parts, axis=0)  # z-major
                q31_parts = None
                q31d = eng.put_dense(q31h)
                del q31h
                q31hat = eng.to_spec(q31d, eng.zeros_spec())
                q31d = None

            # ---- displacement row streaming -------------------------
            stream_ready.wait()
            stream = box["stream"]
            stream.check()                # surfaces a needed-prep error
            counts = prep["counts"]
            offsets = prep["offsets"]
            idx_dev = eng.put_rows(prep["idx_pad"])
            prep["idx_pad"] = None

            def stream_rows(key, u_v):
                buf = stream.buffer(key)

                def land(j0, K, fut):
                    rows = fut.result()
                    for jj in range(K):
                        j = j0 + jj
                        n_j = counts[j]
                        r = rows[jj] if rows.ndim == 3 else rows
                        buf[offsets[j]:offsets[j] + n_j] = r[:n_j]
                    stream.advance(key, int(offsets[j0 + K]))

                # grouping K slabs per dispatch trims round trips, with
                # K and the in-flight transfer-buffer depth bounded by
                # the v-phase ledger (group_rows); at N >= 1024 fewer
                # landed-row buffers stay in flight
                depth = 2 if N < 1024 else 1
                pend = []
                j0 = 0
                while j0 < nsl:
                    K = min(eng.group_rows, nsl - j0)
                    rows_dev = (eng.vrows_slab(u_v, idx_dev,
                                               jnp.int32(j0)) if K == 1
                                else eng.vrows_group(u_v, idx_dev,
                                                     jnp.int32(j0), K=K))
                    fut = ex.submit(np.asarray, rows_dev)
                    pend.append((j0, K, fut))
                    while len([1 for *_, f in pend
                               if not f.done()]) > depth:
                        time.sleep(0.005)
                    while pend and pend[0][2].done():
                        land(*pend.pop(0))
                    j0 += K
                for j0, K, f in pend:
                    land(j0, K, f)

            seg_z = [z0out]
            if multi_seg:
                seg_z += list(params.output_z[1:])
            dummy = jnp.zeros((2, 1, 1, 1), eng.dtype)
            u_v = eng.zeros_stack(3)
            for s, zs in enumerate(seg_z):
                # the source spectra stay resident until the LAST
                # segment's stream has consumed them (the v-stream
                # ledger already peaks with all three alive)
                last = s == len(seg_z) - 1
                key = (lambda k: k) if s == 0 \
                    else (lambda k: ("seg", s, k))
                u_v = eng.build_first(u_v, dummy, growth(0, zs),
                                      source="density")
                stream_rows(key("v1"), u_v)
                if lpt_order >= 2:
                    u_v = eng.build_first(u_v, q2hat, growth(1, zs),
                                          source="spec")
                    stream_rows(key("v2"), u_v)
                    if last:
                        q2hat = None
                if lpt_order >= 3:
                    u_v = eng.build_first(u_v, q31hat, growth(2, zs),
                                          source="spec")
                    stream_rows(key("v31"), u_v)
                    if last:
                        q31hat = None
                    u_v = eng.build_first(u_v, q32hat, growth(3, zs),
                                          source="spec")
                    stream_rows(key("v32"), u_v)
                    if last:
                        q32hat = None
            u_v = idx_dev = None
            timings["lpt"] = time.perf_counter() - ts
        except BaseException as e:                     # noqa: BLE001
            stream_ready.wait()
            st = box.get("stream")
            if st is not None:
                st.fail(e)
            else:
                raise
        finally:
            ex.shutdown(wait=True)

    lpt_th = None
    if overlap:
        lpt_th = threading.Thread(target=lpt_phase, daemon=True)
        lpt_th.start()

    prep_th.join()
    if "error" in prep:
        stream = _OocStream(0, lpt_keys)
        stream.fail(prep["error"])
        box["stream"] = stream
        stream_ready.set()
        raise prep["error"]
    ntot = prep["ntot"]
    stream = _OocStream(ntot, lpt_keys)
    box["stream"] = stream
    stream_ready.set()
    if verbose:
        print(f"  ooc products: {ntot}/{N ** 3} needed particles "
              f"({100.0 * ntot / N ** 3:.1f}%), slab cap {prep['cap']}"
              + (", streams overlapped with fragmentation" if overlap
                 else ""), flush=True)
    if not overlap:
        lpt_phase()
        stream.check()

    from .fmax import StreamingVel
    vel = StreamingVel(stream, {k: k for k in base_keys}, ntot)
    sp = SparseProducts(N=N, ci=prep["ci"], F=prep["F"], vel=vel,
                        sorted_by="ci")
    vel_segments = None
    if multi_seg:
        # sparse RECOMPUTE segments aligned row-for-row with vel (the
        # sweep reads them through the same rowmap + watermark)
        vel_segments = [vel] + [
            StreamingVel(stream, {k: ("seg", s, k) for k in base_keys},
                         ntot)
            for s in range(1, len(params.output_z))]
        sp.segments = vel_segments
    # consumers expect the monolithic [x, y, z] orientation; the
    # transpose is a zero-copy view of the z-major store
    products = Products(Fmax=F_host.transpose(1, 2, 0), Rmax=None,
                        vel={})
    return FmaxResult(products=products, smoothing=sm, grid=eng.grid,
                      kdensity=None, host_products=sp, timings=timings,
                      pdf_hist=prep["hist"], vel_segments=vel_segments,
                      seg_sparse=vel_segments is not None,
                      ooc_pending=_OocPending(lpt_th, stream, timings))
