"""The fmax pipeline: collapse times + LPT displacements on the device.

Drives the outer smoothing-radius loop of the reference (compute_fmax,
fmax.c:36-190): for each radius in the variance ladder, compute the 6
second derivatives of the smoothed potential (6 c2r FFTs) and update each
particle's earliest collapse time Fmax; then at R=0 compute the Zel'dovich +
2LPT + 3LPT displacement fields.

Everything stays on device; the host loop over ~5-30 radii calls one jitted
step whose only retrace-relevant argument is the grid size.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from .backend import transfer_policy
from .config import Params
from .cosmology import Cosmology
from .grids import Grid
from .ic import generate_kdensity
from .ops import collapse, derivatives, lpt

NSIGMA = 6.0
STEP_VAR = 0.3          # spacing of the variance ladder (pinocchio.h:69)

# grid size at which the displacement stage switches from one monolithic
# device program to per-field staged programs with explicit buffer
# lifetimes (module-level so tests can lower it and cover the staged path
# at CPU-sized grids; ROADMAP lists re-measuring it on the H100)
STAGED_LPT_THRESHOLD = 512


@dataclass
class Smoothing:
    """The smoothing-radius ladder (set_smoothing, initialization.c:386-435).

    Radii in true Mpc; variances from the Gaussian-window linear variance.
    """
    radii: np.ndarray
    variance: np.ndarray
    true_variance: np.ndarray = None

    @property
    def n(self) -> int:
        return len(self.radii)

    @classmethod
    def build(cls, params: Params, cosmo: Cosmology) -> "Smoothing":
        D = float(cosmo.GrowingMode(params.zlast, params.k_for_GM))
        var_min = (1.686 / NSIGMA / D) ** 2
        rmin = params.InterPartDist / 6.0
        var_max = float(cosmo.var_gauss.MassVariance(rmin))
        nsmooth = int((math.log10(var_max) - math.log10(var_min))
                      / STEP_VAR + 2)
        if nsmooth <= 0:
            nsmooth = 1
        radii = np.zeros(nsmooth)
        variance = np.zeros(nsmooth)
        for i in range(nsmooth - 1):
            variance[i] = 10.0 ** (math.log10(var_min) + STEP_VAR * i)
            radii[i] = cosmo.var_gauss.Radius(variance[i])
        radii[-1] = 0.0
        variance[-1] = var_max
        return cls(radii=radii, variance=variance,
                   true_variance=np.zeros(nsmooth))


@dataclass
class Products:
    """Per-particle outputs of fmax (product_data, pinocchio.h:233-259),
    kept as [N, N, N]-shaped device arrays; C-order flattening reproduces
    the reference's particle index (z fastest)."""
    Fmax: jax.Array
    Rmax: jax.Array
    vel: Dict[str, jax.Array]          # 'v1','v2','v31','v32' -> [3,N,N,N]
    zacc: jax.Array = None             # SNAPSHOT-mode accretion redshift


@dataclass
class SparseProducts:
    """Host-side products restricted to the needed particles (the V5
    needed-particle memory model, DOCUMENTATION:206-213): fragmentation
    host memory scales with the collapsed fraction (~1/3), not N^3."""
    N: int
    ci: np.ndarray                     # global cell index, int64
    F: np.ndarray                      # float32 per needed particle
    vel: Dict[str, np.ndarray]         # key -> [n, 3] float32
    # row order: "ci" (ascending cell index) or "F" (descending collapse
    # time, ties by ascending cell index — the sweep's processing order,
    # pre-sorted ON DEVICE so sub-box loading skips the host argsort)
    sorted_by: str = "ci"
    # RECOMPUTE_DISPLACEMENTS segment rows aligned with `vel` (set when
    # segments were routed by the cross-host exchange)
    segments: list = None


# tiny jitted helpers at module level: a fresh jax.jit wrapper per call
# would retrace (and recompile) on every run
_count_ge = jax.jit(lambda F, Flast: (F.ravel() >= Flast).sum())
_cast_f16 = jax.jit(lambda x: x.astype(jnp.float16))
_pdf_bincount = jax.jit(lambda F: jnp.bincount(
    jnp.clip((F.ravel().astype(jnp.float32) * 10.0).astype(jnp.int32),
             0, 209), length=210))


@partial(jax.jit, static_argnames=("cap",))
def _compact_idx(F, Flast, cap):
    """Needed-particle cell indices + Fmax, compacted AND sorted by
    descending Fmax on device (ties by ascending cell index — exactly the
    order argsort(-F, stable) over ci-ascending rows produces, which is
    the sweep's processing order, fragment.c:484-520).  Sorting on the
    accelerator makes sub-box loading a pure order-preserving filter on
    the host.  Unfilled tail slots stay -1."""
    Ff = F.ravel()
    mask = Ff >= Flast
    key = jnp.where(mask, -Ff, jnp.float32(np.inf))
    order = jnp.argsort(key, stable=True)[:cap]
    idx = jnp.where(mask[order], order.astype(jnp.int32), -1)
    Fs = jnp.where(mask[order], Ff[order], 0.0)
    return idx, Fs


N_CHUNKS = 16       # d2h chunks per displacement table (watermark grain)
_STREAM_TEST_DELAY = 0.0    # tests inject per-chunk latency here


def _chunk_bounds(cap: int, k: int = N_CHUNKS):
    return [cap * i // k for i in range(k + 1)]


@partial(jax.jit, static_argnames=("f16",))
def _gather_rows(v, idx, f16: bool):
    """Needed rows of one displacement stack, [cap, 3] wire layout: the
    valid entries are a PREFIX (idx is (-F, cell)-sorted with non-needed
    keyed last), so the host side never re-sorts — and the rows cross the
    link in EXACTLY the sweep's processing order, which is what lets the
    sweep start on a delivered prefix (rows_ready watermark)."""
    safe = jnp.maximum(idx, 0)
    rows = v.reshape(3, -1)[:, safe].T
    return rows.astype(jnp.float16) if f16 else rows


def _chunk_rows(rows):
    """Split a [cap, 3] device array into N_CHUNKS static slices so each
    chunk's d2h transfer completes (and advances the watermark)
    independently."""
    b = _chunk_bounds(rows.shape[0])
    return tuple(rows[b[i]:b[i + 1]] for i in range(N_CHUNKS))


@partial(jax.jit, static_argnames=("f16",))
def _gather_rows_chunked(v, idx, f16: bool):
    return _chunk_rows(_gather_rows.__wrapped__(v, idx, f16))


class _PriorityPool:
    """Tiny 2-thread pool draining a priority heap of transfer tasks.

    priority = (chunk index, table index) makes the watermark — the MIN
    delivered prefix across tables — advance evenly instead of one table
    finishing at a time."""

    def __init__(self, workers: int = 2):
        import heapq
        import threading
        self._heapq = heapq
        self._heap = []
        self._cv = threading.Condition()
        self._stop = False
        self._seq = 0
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(workers)]
        for t in self._threads:
            t.start()

    def submit(self, priority, fn):
        with self._cv:
            self._heapq.heappush(self._heap, (priority, self._seq, fn))
            self._seq += 1
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait()
                if not self._heap:
                    return
                _, _, fn = self._heapq.heappop(self._heap)
            fn()

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class TransferLog:
    """Bytes and seconds of the device->host product transfer.  Each
    array is waited for (its program done) before its copy is timed, so
    busy_s is copy time only: the sum over arrays, which the two
    transfer threads may overlap; window_s runs from the first copy's
    start to the last copy's end."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.nbytes = 0
        self.busy_s = 0.0
        self._t0 = self._t1 = None

    def fetch(self, x) -> np.ndarray:
        if hasattr(x, "block_until_ready"):
            x.block_until_ready()
        t0 = time.perf_counter()
        h = np.asarray(x)
        t1 = time.perf_counter()
        with self._lock:
            self.nbytes += h.nbytes
            self.busy_s += t1 - t0
            self._t0 = t0 if self._t0 is None else min(self._t0, t0)
            self._t1 = t1 if self._t1 is None else max(self._t1, t1)
        return h

    def summary(self) -> dict:
        window = 0.0 if self._t0 is None else self._t1 - self._t0
        return dict(bytes=self.nbytes, busy_s=self.busy_s, window_s=window)


class _StreamState:
    """Chunked d2h streams for the displacement tables.

    Each expected table fills a preallocated float32 [cap, 3] host buffer
    chunk by chunk (f16 wire chunks upcast on arrival); `ready[0]` counts
    the leading rows delivered across ALL expected tables — the pointer
    the C sweep spin-waits on (groupsweep.c rows_ready)."""

    def __init__(self, cap: int, keys, log: TransferLog):
        import threading
        self.cap = cap
        self.keys = list(keys)
        self.log = log
        self.buffers = {}
        self._bounds = {}
        self._delivered = {k: 0 for k in self.keys}
        self._prefix = {k: 0 for k in self.keys}     # contiguous chunks
        self._chunks_done = {k: set() for k in self.keys}
        self._events = {k: threading.Event() for k in self.keys}
        self.ready = np.zeros(1, np.int64)
        self._lock = threading.Lock()
        self.error = None
        self._pool = _PriorityPool()

    def enqueue(self, key, chunks):
        """chunks: tuple of device arrays slicing the table's [cap, 3]
        rows at _chunk_bounds; transfers start immediately, watermark
        advances as contiguous prefixes land."""
        if key not in self._delivered:          # unexpected table: track
            self._register(key)
        buf = self.buffer(key)
        bounds = _chunk_bounds(self.cap, len(chunks))
        self._bounds[key] = bounds
        kidx = self.keys.index(key)
        nch = len(chunks)
        for ci in range(nch):
            ch = chunks[ci]
            i0, i1 = bounds[ci], bounds[ci + 1]

            def task(key=key, ci=ci, ch=ch, i0=i0, i1=i1, nch=nch):
                try:
                    if _STREAM_TEST_DELAY:        # tests: simulate a
                        time.sleep(_STREAM_TEST_DELAY)   # slow link
                    buf[i0:i1] = self.log.fetch(ch)   # f16 -> f32
                    self._chunk_done(key, ci, nch)
                except BaseException as e:        # noqa: BLE001
                    self.fail(e)
            self._pool.submit((ci, kidx), task)

    def _register(self, key):
        import threading
        self.keys.append(key)
        self._delivered[key] = 0
        self._prefix[key] = 0
        self._chunks_done[key] = set()
        self._events[key] = threading.Event()

    def buffer(self, key):
        with self._lock:
            b = self.buffers.get(key)
            if b is None:
                b = self.buffers[key] = np.empty((self.cap, 3), np.float32)
        return b

    def _chunk_done(self, key, ci, nchunks):
        with self._lock:
            done = self._chunks_done[key]
            done.add(ci)
            d = self._prefix[key]
            while d in done:
                d += 1
            self._prefix[key] = d
            self._delivered[key] = self._bounds[key][d]
            self.ready[0] = min(self._delivered.values())
            if len(done) == nchunks:
                self._events[key].set()
                if all(ev.is_set() for ev in self._events.values()):
                    self._pool.shutdown()

    def fail(self, err):
        self.error = err
        with self._lock:
            # unblock the sweep: the driver re-raises after it returns
            self.ready[0] = self.cap
            for ev in self._events.values():
                ev.set()
            self._pool.shutdown()

    def wait(self, key):
        self._events[key].wait()
        if self.error:
            raise self.error

    def check(self):
        if self.error:
            raise self.error


class StreamingVel:
    """Dict-like view over a _StreamState for one displacement set:
    __getitem__ BLOCKS until that table is fully delivered (exchange,
    snapshot and dump consumers keep their semantics); the fragmentation
    driver instead reads `buffer()` non-blocking and hands the C sweep
    the rows_ready watermark."""

    def __init__(self, stream: _StreamState, keymap: dict, n: int):
        self.stream = stream
        self._keymap = keymap          # public key -> stream key
        self._n = n

    def __contains__(self, k):
        return k in self._keymap

    def __iter__(self):
        return iter(self._keymap)

    def __len__(self):
        return len(self._keymap)

    def keys(self):
        return self._keymap.keys()

    def __getitem__(self, k):
        sk = self._keymap[k]
        self.stream.wait(sk)
        return self.stream.buffers[sk][:self._n]

    def get(self, k, default=None):
        return self[k] if k in self._keymap else default

    def items(self):
        return [(k, self[k]) for k in self._keymap]

    def values(self):
        return [self[k] for k in self._keymap]

    def buffer(self, k):
        """Non-blocking view (possibly still filling, watermark-guarded)."""
        return self.stream.buffer(self._keymap[k])[:self._n]


def _expected_stream_keys(params) -> list:
    """The exact table set a run_fmax sparse fetch will deliver: the
    watermark is the MIN delivered prefix over these, so the set must
    match what gets enqueued or the sweep never starts."""
    keys = ["v1"]
    if params.lpt_order >= 2:
        keys.append("v2")
    if params.lpt_order >= 3:
        keys += ["v31", "v32"]
    out = list(keys)
    if params.recompute_displacements and len(params.output_z) > 1:
        for s in range(1, len(params.output_z)):
            out += [("seg", s, k) for k in keys]
    return out


class PendingFetch:
    """Overlapped sparse product fetch (the GPU default): the index/Fmax
    compaction is dispatched right after the collapse cycle and its
    device->host transfer rides alongside the LPT displacement programs;
    each displacement stack's compacted rows cross the link in N_CHUNKS
    prefix chunks the moment that stack's program retires, and the
    fragmentation sweep STARTS on the delivered prefix (rows arrive in
    sweep order by construction; groupsweep.c rows_ready watermark)
    instead of waiting for the full tables."""

    def __init__(self, params, Fmax, N: int, expected_keys=None):
        from concurrent.futures import ThreadPoolExecutor
        self.N = N
        self.t0 = time.perf_counter()
        _, self.f16 = transfer_policy(params)
        N3 = N * N * N
        Flast = jnp.float32(params.Flast)
        count = int(np.asarray(_count_ge(Fmax, Flast)))
        step = max(1, N3 // 16)
        self.cap = (min(N3, ((count + step - 1) // step) * step)
                    if count else step)
        self.count = count
        idx, Fs = _compact_idx(Fmax, Flast, cap=self.cap)
        self.idx_dev = idx                 # device-side, for row gathers
        self.ex = ThreadPoolExecutor(max_workers=2)
        self.log = TransferLog()
        self.idx_fut = self.ex.submit(self.log.fetch, idx)
        self.f_fut = self.ex.submit(self.log.fetch, Fs)
        if expected_keys is None:
            expected_keys = _expected_stream_keys(params)
        self.stream = _StreamState(self.cap, expected_keys, self.log)
        self._main_keys = [k for k in expected_keys
                           if not isinstance(k, tuple)]
        self._nseg = 1 + max((k[1] for k in expected_keys
                              if isinstance(k, tuple)), default=0)

    def add_vel(self, key: str, v):
        self.stream.enqueue(key, _gather_rows_chunked(v, self.idx_dev,
                                                      f16=self.f16))

    def add_rows(self, key: str, chunks):
        """chunks already gathered+split on device
        (displacement_stage_fetch): just start the transfers."""
        self.stream.enqueue(key, chunks)

    def add_seg(self, iseg: int, key: str, v_or_chunks, gathered=False):
        """RECOMPUTE_DISPLACEMENTS segment stack: transfer only the
        needed rows (the dense per-segment transfer was the remaining
        N^3-sized d2h in recompute runs)."""
        chunks = v_or_chunks if gathered else _gather_rows_chunked(
            v_or_chunks, self.idx_dev, f16=self.f16)
        self.stream.enqueue(("seg", iseg, key), chunks)

    def finish(self, verbose: bool = False) -> SparseProducts:
        if getattr(self, "_sp", None) is not None:
            return self._sp
        idx_h = self.idx_fut.result()
        valid = idx_h >= 0
        ci = idx_h[valid].astype(np.int64)
        F_c = self.f_fut.result()[valid]
        n = len(ci)

        vel_c = StreamingVel(self.stream, {k: k for k in self._main_keys},
                             n)
        # sparse RECOMPUTE segments, aligned row-for-row with vel_c
        self.segments = None
        if self._nseg > 1:
            self.segments = [vel_c] + [
                StreamingVel(self.stream,
                             {k: ("seg", s, k) for k in self._main_keys},
                             n)
                for s in range(1, self._nseg)]
        self.ex.shutdown(wait=False)
        self.idx_dev = None            # release the device index buffer
        if verbose:
            nb = self.cap * (8 + 6 * len(self._main_keys)
                             * (2 if self.f16 else 4))
            print(f"  products: {self.count}/{self.N ** 3} needed "
                  f"particles ({100.0 * self.count / self.N ** 3:.1f}%), "
                  f"{nb / 1e6:.0f} MB streaming, overlapped with LPT + "
                  f"sweep ({time.perf_counter() - self.t0:.1f}s since "
                  f"cycle)")
        self._sp = SparseProducts(N=self.N, ci=ci, F=F_c, vel=vel_c,
                                  sorted_by="F")
        return self._sp


@dataclass
class FmaxResult:
    products: Products
    smoothing: Smoothing
    grid: Grid
    kdensity: jax.Array
    # RECOMPUTE_DISPLACEMENTS: one displacement set per output redshift
    # (list of dicts of host [3,N,N,N] arrays); None in single-segment mode
    vel_segments: list = None
    # deferred distributed segments: device-sharded stacks kept for the
    # cross-host exchange to route (parallel/exchange.py)
    vel_segments_dev: list = None
    # set by fetch_products_host on a sparse transfer: compact host copy
    host_products: SparseProducts = None
    # in-flight overlapped fetch (resolved by fetch_products_host)
    pending_fetch: PendingFetch = None
    # vel_segments entries are [n, 3] rows aligned with host_products
    # instead of dense [3, N, N, N] grids
    seg_sparse: bool = False
    # ooc engine: FmaxPDF histogram precomputed during needed-prep (the
    # dense grid never needs to revisit the device), and the handle for
    # the in-flight background LPT phase (fmax_ooc._OocPending) that
    # run_pipeline joins after fragmentation
    pdf_hist: np.ndarray = None
    ooc_pending: object = None
    timings: Dict[str, float] = field(default_factory=dict)


@partial(jax.jit, static_argnames=("N", "nsmooth"))
def fmax_loop(kdensity, radii_grid, invgrow_packs, N: int, nsmooth: int):
    """The full smoothing-radius cycle (fmax.c:66-150) as ONE device
    program: a lax.scan over radii whose body does the 6 derivative FFTs +
    the collapse update.

    One dispatch + one host sync per run, and the scan keeps the XLA
    program size independent of the number of radii (a fully unrolled
    512^3 program overwhelms the compiler).

    invgrow_tabs is [nsmooth, ntab] (one inverse-growth table per radius —
    rows are identical unless growth is scale-dependent, where the smoothed
    density's effective growth replaces the k=0 one; SPLINE_INVGROW,
    initialization.c:1551-1707); invgrow_lo/dx are [nsmooth].

    Returns (Fmax, Rmax, d_avg[nsmooth], d_var[nsmooth], sd) with sd the
    R=0 Hessian stack for the LPT stage.
    """
    Fmax0 = jnp.full((N, N, N), -10.0, jnp.float32)
    Rmax0 = jnp.full((N, N, N), -1, jnp.int32)
    sd0 = jnp.zeros((6, N, N, N), jnp.float32)

    def body(carry, xs):
        Fmax, Rmax, _ = carry
        R_grid, ism, pack = xs
        sd = derivatives.second_derivatives.__wrapped__(kdensity, R_grid, N)
        Fmax, Rmax, d_avg, d_var = collapse.collapse_update.__wrapped__(
            sd, Fmax, Rmax, ism, pack)
        return (Fmax, Rmax, sd), (d_avg, d_var)

    xs = (radii_grid, jnp.arange(nsmooth, dtype=jnp.int32), invgrow_packs)
    (Fmax, Rmax, sd), (avgs, variances) = jax.lax.scan(
        body, (Fmax0, Rmax0, sd0), xs, length=nsmooth)
    return Fmax, Rmax, avgs, variances, sd


@partial(jax.jit, static_argnames=("N", "nsmooth", "interp"))
def fmax_loop_tab(kdensity, radii_grid, ct_tabs, ct_dv, ct_idx_map,
                  ct_ampls, N: int, nsmooth: int, ct_tabs2=None,
                  interp: str = "trilinear"):
    """fmax_loop variant where collapse times come from per-radius
    TABULATED_CT tables (ELL_SNG or tabulated classic), in any of the
    three interpolation variants (collapse_times.c:1139-1231)."""
    Fmax0 = jnp.full((N, N, N), -10.0, jnp.float32)
    Rmax0 = jnp.full((N, N, N), -1, jnp.int32)
    sd0 = jnp.zeros((6, N, N, N), jnp.float32)
    if ct_tabs2 is None:
        if interp != "trilinear":
            # zero second derivatives would silently degrade the delta
            # splines of the BILINEAR_SPLINE/ALL_SPLINE variants to
            # piecewise-linear
            raise ValueError(f"interp={interp!r} needs the spline "
                             "second-derivative tables: pass ct_tabs2 "
                             "(prepare_ct_tables provides them)")
        ct_tabs2 = jnp.zeros_like(ct_tabs)

    def body(carry, xs):
        Fmax, Rmax, _ = carry
        R_grid, ism, tab, tab2, ampl = xs
        sd = derivatives.second_derivatives.__wrapped__(kdensity, R_grid, N)
        Fmax, Rmax, d_avg, d_var = collapse.collapse_update_table.__wrapped__(
            sd, Fmax, Rmax, ism, tab, ct_dv, ct_idx_map, ampl,
            ct_tab2=tab2, interp=interp)
        return (Fmax, Rmax, sd), (d_avg, d_var)

    xs = (radii_grid, jnp.arange(nsmooth, dtype=jnp.int32), ct_tabs,
          ct_tabs2, ct_ampls)
    (Fmax, Rmax, sd), (avgs, variances) = jax.lax.scan(
        body, (Fmax0, Rmax0, sd0), xs, length=nsmooth)
    return Fmax, Rmax, avgs, variances, sd


def _displacement_core(kdensity, sd, growths, N: int, order: int,
                       scaledep: bool):
    def first(kvec, iorder):
        if scaledep:
            gtabs, glo, gdx = growths
            return derivatives.first_derivatives_tab.__wrapped__(
                kvec, gtabs[iorder], glo, gdx, N)
        return derivatives.first_derivatives.__wrapped__(
            kvec, growths[iorder], N)

    out = {}
    if order >= 2:
        kvec2, kvec31, kvec32 = lpt.lpt_sources.__wrapped__(sd, N)
        out["v2"] = first(kvec2, 1)
        if order >= 3:
            out["v31"] = first(kvec31, 2)
            out["v32"] = first(kvec32, 3)
    out["v1"] = first(kdensity, 0)
    return out


@partial(jax.jit, static_argnames=("N", "order", "scaledep"))
def displacement_stage(kdensity, sd, growths, N: int, order: int,
                       scaledep: bool = False):
    """All LPT sources + displacement stacks as one device program
    (compute_displacements, fmax.c:292-367).

    growths: scalars (D1, D2, D31, D32) when scale-independent, else
    (gtabs[4, ntab], glo, gdx) per-mode growth tables over log10 |k|.
    """
    return _displacement_core(kdensity, sd, growths, N, order, scaledep)


@partial(jax.jit, static_argnames=("N", "order", "scaledep", "f16"))
def displacement_stage_fetch(kdensity, sd, growths, idx, N: int,
                             order: int, scaledep: bool, f16: bool):
    """displacement_stage + the needed-row gathers fused into ONE device
    program: below the staged threshold the whole LPT-and-compact step
    is a single dispatch whose outputs then stream to the host on
    parallel transfer threads."""
    vel = _displacement_core(kdensity, sd, growths, N, order, scaledep)
    safe = jnp.maximum(idx, 0)
    rows = {}
    for k, v in vel.items():
        r = v.reshape(3, -1)[:, safe].T      # [cap, 3] wire layout
        rows[k] = _chunk_rows(r.astype(jnp.float16) if f16 else r)
    return vel, rows


def growth_k_tables(cosmo: Cosmology, z0: float, N: int, ntab: int = 512):
    """Per-order growth D_i(z0, k) tables over log10 |k| in GRID units,
    replicating the reference's grid-unit k in the growth switch
    (fmax-pfft.c:340-364)."""
    lo = math.log10(2.0 * math.pi / N) - 2.0
    hi = math.log10(math.pi * math.sqrt(3.0)) + 0.1
    logk = np.linspace(lo, hi, ntab)
    k = 10.0 ** logk
    tabs = np.stack([
        np.asarray(cosmo.GrowingMode(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_2LPT(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_1(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_2(z0, k), np.float32)])
    return (jnp.asarray(tabs), jnp.float32(lo),
            jnp.float32(logk[1] - logk[0]))


def prepare_ct_tables(params: Params, cosmo: Cosmology, sm: Smoothing,
                      verbose: bool = True) -> dict:
    """Per-radius TABULATED_CT / ELL_SNG collapse tables: load from
    CTtableFile when present and consistent (header checks,
    collapse_times.c:1235-1345), else build and optionally cache."""
    from .ops import tabulated
    model = "sng" if params.ell_model == "sng" else "classic"
    ct = None
    if params.CTtableFile not in ("none", ""):
        try:
            tabs = tabulated.read_ct_table_file(params.CTtableFile,
                                                params, sm)
            dv64 = tabulated.delta_sampling()
            ct = dict(tables=tabs,
                      tables2=tabulated.spline_d2(tabs, dv64),
                      dv=dv64.astype(np.float32),
                      idx_map=None,
                      ampl=np.sqrt(sm.variance).astype(np.float32))
            aux = np.linspace(-tabulated.CT_RANGE_D,
                              tabulated.CT_RANGE_D, tabulated.AUX_N)
            ct["idx_map"] = np.clip(
                np.searchsorted(ct["dv"], aux, side="right") - 1, 0,
                tabulated.CT_NBINS_D - 2).astype(np.int32)
            if verbose:
                print(f"  collapse tables read from {params.CTtableFile}")
        except (OSError, ValueError):
            ct = None
    if ct is None:
        if verbose:
            print(f"  building {model} collapse tables for {sm.n} radii")
        ct = tabulated.build_ct_tables_all(cosmo, sm, model=model)
        if params.CTtableFile not in ("none", ""):
            tabulated.write_ct_table_file(params.CTtableFile, params,
                                          sm, ct["tables"])
    return ct


def inverse_growth_packs(cosmo: Cosmology, sm: Smoothing,
                         scaledep_gm=None) -> np.ndarray:
    """Per-radius inverse-growing-mode polynomial fits [nsmooth, pack]:
    with scale-dependent growth each radius inverts the smoothed density's
    effective growth (InverseGrowingMode, cosmo.c:1822-1832)."""
    if scaledep_gm is not None:
        return np.stack([collapse.fit_inverse_growth(
            scaledep_gm.invgrow_logD[i], scaledep_gm.loga_grid)
            for i in range(sm.n)])
    return np.tile(collapse.make_inverse_growth_fit(cosmo)[None, :],
                   (sm.n, 1))


def run_fmax(params: Params, cosmo: Cosmology, kdensity=None,
             scaledep_gm=None, verbose: bool = True,
             keep_dense_products: bool = False) -> FmaxResult:
    grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
    N = grid.N
    sm = Smoothing.build(params, cosmo)
    timings = {}

    t0 = time.perf_counter()
    if kdensity is None:
        kdensity = generate_kdensity(grid, cosmo, params.RandomSeed,
                                     fixed=params.FixedIC,
                                     paired=params.PairedIC)
        kdensity.block_until_ready()
    timings["dens"] = time.perf_counter() - t0

    ig_packs = jnp.asarray(inverse_growth_packs(cosmo, sm, scaledep_gm))

    # ---- cycle on smoothing radii (fmax.c:66-150), one device program ----
    t0 = time.perf_counter()
    radii_grid = jnp.asarray(sm.radii / grid.CellSize, jnp.float32)
    if params.ell_model != "classic":
        # TABULATED_CT / ELL_SNG: build (or load) the per-radius tables
        ct = prepare_ct_tables(params, cosmo, sm, verbose=verbose)
        Fmax, Rmax, d_avgs, d_vars, sd = fmax_loop_tab(
            kdensity, radii_grid, jnp.asarray(ct["tables"]),
            jnp.asarray(ct["dv"]), jnp.asarray(ct["idx_map"]),
            jnp.asarray(ct["ampl"]), N, sm.n,
            ct_tabs2=jnp.asarray(ct["tables2"]),
            interp=params.ct_interp)
    else:
        Fmax, Rmax, d_avgs, d_vars, sd = fmax_loop(
            kdensity, radii_grid, ig_packs, N, sm.n)
    sm.true_variance[:] = np.asarray(d_vars)   # d2h sync
    timings["fmax_loop"] = time.perf_counter() - t0
    if verbose:
        for ism in range(sm.n):
            print(f"  smoothing {ism + 1}/{sm.n}: R={sm.radii[ism]:9.5f} "
                  f"expected sigma {math.sqrt(sm.variance[ism]):7.4f} "
                  f"computed "
                  f"{math.sqrt(max(sm.true_variance[ism], 0.0)):7.4f}")

    # ---- displacements at R=0 (fmax.c:152-169, LPT.c) ----
    # the last iteration left the unsmoothed Hessian in sd
    t0 = time.perf_counter()
    # overlapped sparse fetch: dispatch the needed-particle compaction
    # NOW so its device->host transfer rides alongside the LPT programs
    # (fetch_products_host resolves it; dense path untouched on CPU)
    sparse_now, f16 = transfer_policy(params)
    # on the staged (N >= 512) path the compaction sort waits for the
    # 6-Hessian release: the 134M+-element device sort needs several GB
    # of workspace, which the planner's staged ledger does not hold
    # next to sd
    pending = (PendingFetch(params, Fmax, N)
               if sparse_now and N < STAGED_LPT_THRESHOLD else None)
    pending_deferred = sparse_now and N >= STAGED_LPT_THRESHOLD
    # a sparse run ships only compacted rows to fragmentation; the dense
    # [3,N,N,N] device stacks are needed afterwards ONLY by the snapshot
    # writer — freeing them as each stack's rows are gathered keeps the
    # 512^3+ staged peak down (4 stacks = 6.5 GB there).  Dumps are
    # sparse per-host chunks now (io/dumps.py) and ride the same rows.
    keep_dense_vel = (not sparse_now
                      or params.WriteTimelessSnapshot
                      or keep_dense_products)
    z0 = params.zlast if not params.recompute_displacements \
        else params.output_z[0]
    scaledep = bool(getattr(cosmo, "scale_dep", False))
    multi_seg = (params.recompute_displacements
                 and len(params.output_z) > 1)

    def growths_at(zz):
        if scaledep:
            return growth_k_tables(cosmo, zz, N)
        return (jnp.float32(cosmo.GrowingMode(zz)),
                jnp.float32(cosmo.GrowingMode_2LPT(zz)),
                jnp.float32(cosmo.GrowingMode_3LPT_1(zz)),
                jnp.float32(cosmo.GrowingMode_3LPT_2(zz)))

    def _fetch(v):
        if f16:
            return np.asarray(_cast_f16(v)).astype(np.float32)
        return np.asarray(v)

    growths = growths_at(z0)
    vel_segments = None
    if N >= STAGED_LPT_THRESHOLD:
        # staged variant: one program per field with explicit buffer
        # lifetimes (a smaller device peak than the monolithic program).
        # The LPT source k-vectors are z-INDEPENDENT (only the growth
        # weights in the derivative stage depend on z, LPT.c:184-228), so
        # with RECOMPUTE_DISPLACEMENTS the 3 k-vectors stay alive across
        # segments while the 6 N^3 Hessian buffers free after lpt_sources.
        def first(kvec, iorder, g):
            if scaledep:
                gtabs, glo, gdx = g
                return derivatives.first_derivatives_tab(
                    kvec, gtabs[iorder], glo, gdx, N)
            return derivatives.first_derivatives(kvec, g[iorder], N)

        kvec2 = kvec31 = kvec32 = None
        if params.lpt_order >= 2:
            kvec2, kvec31, kvec32 = lpt.lpt_sources(sd, N)
            kvec2.block_until_ready()
        sd = None                      # free the 6 Hessian buffers
        if pending_deferred:
            pending = PendingFetch(params, Fmax, N)

        def staged_vels(g, to_host, seg=None):
            """One displacement set; to_host fetches each stack to the
            host as soon as it is computed, so at most one [3,N,N,N]
            device temporary exists at a time.  seg: sparse segment
            transfer through the pending fetch (needed rows only)."""
            out = {}

            def add(key, kvec, iorder):
                v = first(kvec, iorder, g)
                if to_host:
                    if pending is not None and seg is not None:
                        pending.add_seg(seg, key, v)
                    else:
                        out[key] = _fetch(v)
                else:
                    if pending is not None:
                        pending.add_vel(key, v)
                        if not keep_dense_vel:
                            out[key] = None   # freed once rows gathered
                            return
                    v.block_until_ready()
                    out[key] = v

            if kvec2 is not None:
                add("v2", kvec2, 1)
                if params.lpt_order >= 3:
                    add("v31", kvec31, 2)
                    add("v32", kvec32, 3)
            add("v1", kdensity, 0)
            return out

        vel = staged_vels(growths, to_host=False)
        if multi_seg:
            # per-segment displacement sets (compute_displacements per
            # segment, fragment.c:398-429)
            if pending is not None:
                # sparse: needed rows only, resolved with the products
                for s, zseg in enumerate(params.output_z[1:], start=1):
                    staged_vels(growths_at(zseg), to_host=True, seg=s)
            else:
                vel_segments = [{k: _fetch(v) for k, v in vel.items()}]
                for zseg in params.output_z[1:]:
                    vel_segments.append(
                        staged_vels(growths_at(zseg), to_host=True))
        del kvec2, kvec31, kvec32
    else:
        if pending is not None:
            vel, rows = displacement_stage_fetch(
                kdensity, sd, growths, pending.idx_dev, N,
                params.lpt_order, scaledep, pending.f16)
            for k, r in rows.items():
                pending.add_rows(k, r)
            if multi_seg:
                # sparse segments: only the needed rows of each extra
                # segment cross the link (resolved with the products by
                # fetch_products_host)
                for s, zseg in enumerate(params.output_z[1:], start=1):
                    _, segrows = displacement_stage_fetch(
                        kdensity, sd, growths_at(zseg), pending.idx_dev,
                        N, params.lpt_order, scaledep, pending.f16)
                    for k, r in segrows.items():
                        pending.add_seg(s, k, r, gathered=True)
        else:
            vel = displacement_stage(
                kdensity, sd, growths, N, params.lpt_order, scaledep)
            if multi_seg:
                vel_segments = [{k: _fetch(v) for k, v in vel.items()}]
                for zseg in params.output_z[1:]:
                    vs = displacement_stage(kdensity, sd,
                                            growths_at(zseg),
                                            N, params.lpt_order, scaledep)
                    vel_segments.append(
                        {k: _fetch(v) for k, v in vs.items()})
    for v in vel.values():
        if v is not None:
            v.block_until_ready()
    timings["lpt"] = time.perf_counter() - t0

    products = Products(Fmax=Fmax, Rmax=Rmax, vel=vel)
    return FmaxResult(products=products, smoothing=sm, grid=grid,
                      kdensity=kdensity, vel_segments=vel_segments,
                      pending_fetch=pending, timings=timings)


def fetch_products_host(params, fmax_result, verbose: bool = False):
    """Materialize the fmax products on the host for fragmentation,
    transferring only the NEEDED particles.

    The analog of the reference V5 needed-particle maps
    (build_distmap/update_distmap, distribute.c:670-698; two-turn scheme
    fragment.c:193-316): only particles that collapse by the final
    redshift (Fmax >= Flast, typically ~1/3 of the grid) take part in
    fragmentation, so a single jitted compaction program selects them on
    device — compaction of their cell indices, gather of their
    displacement rows (float16 cast when transfer_f16 asks) — and only
    that subset crosses the device->host link.  The dense host arrays the sweep indexes into
    are rebuilt by scatter; unselected cells are zero and are never read
    (the sweep's selection is the same Fmax >= Flast cut).

    Rmax is NOT transferred (the sweep never reads it); the device array
    is kept in the returned Products for snapshot/dump paths.
    """
    import dataclasses

    prods = fmax_result.products
    if fmax_result.host_products is not None \
            or isinstance(prods.Fmax, np.ndarray):
        return fmax_result
    if fmax_result.pending_fetch is not None:
        pf = fmax_result.pending_fetch
        sp = pf.finish(verbose=verbose)
        if pf.segments is not None:
            return dataclasses.replace(fmax_result, host_products=sp,
                                       pending_fetch=None,
                                       vel_segments=pf.segments,
                                       seg_sparse=True)
        return dataclasses.replace(fmax_result, host_products=sp,
                                   pending_fetch=None)
    sparse, f16 = transfer_policy(params)

    if not sparse:
        def fetch(v):
            if f16:
                return np.asarray(_cast_f16(v)).astype(np.float32)
            return np.asarray(v)
        dense = Products(Fmax=np.asarray(prods.Fmax),
                         Rmax=prods.Rmax,
                         vel={k: fetch(v) for k, v in prods.vel.items()})
        return dataclasses.replace(fmax_result, products=dense)

    # post-hoc sparse fetch: the same compaction/transfer machinery the
    # overlapped path uses (PendingFetch), just started now — expected
    # tables are exactly the dense stacks present (never segments)
    pending = PendingFetch(params, prods.Fmax, fmax_result.grid.N,
                           expected_keys=sorted(prods.vel))
    for k in sorted(prods.vel):
        pending.add_vel(k, prods.vel[k])
    sp = pending.finish(verbose=verbose)
    return dataclasses.replace(fmax_result, host_products=sp)


def fmax_pdf(Fmax, fname: str = None, hist=None):
    """Histogram of Fmax (Fmax_PDF, fmax.c:509-550): 210 bins of width
    0.1 in F, counts, matching the reference file format.  Device arrays
    are binned on device (210 counts cross the link, not N^3 floats);
    hist: precomputed counts (the ooc engine bins during needed-prep)."""
    if hist is not None:
        npart = int(np.sum(hist))
    else:
        npart = Fmax.size
    if hist is not None:
        pass
    elif not isinstance(Fmax, np.ndarray):
        hist = np.asarray(_pdf_bincount(Fmax))
    else:
        # float32 math: the ooc engine hands a float16 grid whose largest
        # collapse times overflow f16 when scaled (inf -> int is UB and
        # landed those particles in bin 0 instead of the top bin)
        xF = np.asarray(Fmax).ravel().astype(np.float32) * 10.0
        xF = np.clip(np.nan_to_num(xF, nan=0.0, posinf=209.0,
                                   neginf=0.0).astype(int), 0, 209)
        hist = np.bincount(xF, minlength=210)
    if fname:
        with open(fname, "w") as fd:
            fd.write(f"# Fmax PDF over {npart} particles\n")
            fd.write("# 1-2: F interval\n")
            fd.write("# 3: number of particles in that interval\n#\n")
            for i in range(210):
                hi = 999.0 if i == 209 else (i + 1) / 10.0
                fd.write(f" {i / 10.0:6.1f}   {hi:6.1f}  {hist[i]}\n")
    return hist
