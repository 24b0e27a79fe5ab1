"""Checkpoint / resume of the fmax products.

Equivalent of DumpProducts / ReadProductsFromDumps (fmax.c:372-506,
pinocchio.c:220-236): after the expensive collapse+displacement phase the
per-particle products are written to disk so a later run can skip straight
to fragmentation.  Consistency (grid size, seed, LPT order) is checked on
restart like the reference's summary file.

Default format: SPARSE per-host chunks — each host writes the needed
particles it holds as (ci, F, displacement rows [, RECOMPUTE segment
rows]) in ``products.<host>.npz``, the analog of the reference's per-task
``Task.N`` dump files.  This keeps the dump off the dense N^3
device->host path (the whole point of the V5 needed-particle scheme) and
makes multi-host restart natural: a restart at ANY host count reads the
union of all chunks (deduplicated by cell), unlike the reference's
same-task-count restriction.

A dense full-grid dump is written only when the run also needs dense
products anyway (WriteTimelessSnapshot), because the snapshot writer
reads uncollapsed particles too.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

DUMP_DIR = "DumpProducts"


def _write_summary(ddir, meta):
    tmp = os.path.join(ddir, ".summary.json.tmp")
    with open(tmp, "w") as fd:
        json.dump(meta, fd)
    os.replace(tmp, os.path.join(ddir, "summary.json"))


def _sparsify(params, fmax_result):
    """The needed-particle view of the products on this host:
    (SparseProducts, extra segment row dicts or None)."""
    from ..fmax import SparseProducts, fetch_products_host

    fr = fetch_products_host(params, fmax_result)
    if fr.host_products is not None:
        segs = fr.vel_segments if fr.seg_sparse else None
        return fr, fr.host_products, segs
    # dense host arrays (CPU path): compact here
    N = fr.grid.N
    F = np.asarray(fr.products.Fmax).ravel()
    ci = np.flatnonzero(F >= params.Flast).astype(np.int64)
    vel = {k: np.ascontiguousarray(
        np.asarray(v).reshape(3, -1)[:, ci].T, np.float32)
        for k, v in fr.products.vel.items()}
    sp = SparseProducts(N=N, ci=ci, F=F[ci].astype(np.float32), vel=vel,
                        sorted_by="ci")
    segs = None
    if fr.vel_segments is not None:
        if fr.seg_sparse:
            segs = fr.vel_segments
        else:
            segs = [{k: np.ascontiguousarray(
                np.asarray(v).reshape(3, -1)[:, ci].T, np.float32)
                for k, v in seg.items()} for seg in fr.vel_segments]
    return fr, sp, segs


def dump_products(params, fmax_result, directory=".",
                  hosts=(0, 1)) -> str:
    h, H = hosts
    ddir = os.path.join(directory, DUMP_DIR)
    os.makedirs(ddir, exist_ok=True)
    meta = dict(GridSize=params.GridSize, RandomSeed=params.RandomSeed,
                BoxSize=params.BoxSize, lpt_order=params.lpt_order,
                nsmooth=int(fmax_result.smoothing.n), nhosts=H,
                radii=[float(x) for x in fmax_result.smoothing.radii],
                variance=[float(x)
                          for x in fmax_result.smoothing.variance],
                true_variance=[float(x) for x in
                               fmax_result.smoothing.true_variance])

    dense = params.WriteTimelessSnapshot and H == 1
    meta["format"] = "dense" if dense else "sparse"
    if dense:
        # full-grid dump: only when the snapshot writer needs the dense
        # products anyway (it reads uncollapsed particles too)
        _write_summary(ddir, meta)
        arrays = dict(Fmax=np.asarray(fmax_result.products.Fmax),
                      Rmax=np.asarray(fmax_result.products.Rmax))
        for k, v in fmax_result.products.vel.items():
            arrays[f"vel_{k}"] = np.asarray(v)
        path = os.path.join(ddir, "products.npz")
        np.savez(path, **arrays)
        return path

    if H > 1:
        # per-host share straight off this host's own chips; the restart
        # reads the union of every host's chunk
        from ..parallel.multihost import fetch_local_sparse
        sp, segs = fetch_local_sparse(params, fmax_result), None
        if fmax_result.vel_segments is not None \
                and fmax_result.seg_sparse:
            segs = fmax_result.vel_segments
    else:
        _, sp, segs = _sparsify(params, fmax_result)

    # displacement rows are stored in the wire dtype: with the f16 wire
    # they crossed the device->host link as f16 already, so the f16 dump
    # is lossless and HALF the checkpoint bytes (~19 GB instead of 38 at
    # 1024^3)
    from ..backend import transfer_policy
    _, f16 = transfer_policy(params)
    wire = np.float16 if f16 else np.float32
    arrays = dict(ci=sp.ci, F=np.asarray(sp.F, np.float32))
    for k, v in sp.vel.items():
        arrays[f"vel_{k}"] = np.asarray(v, wire)
    nseg = 0
    if segs is not None:
        # segment 0 is the displacement set itself; store the rest
        nseg = len(segs)
        for s, seg in enumerate(segs[1:], start=1):
            for k, v in seg.items():
                if v is not None:
                    arrays[f"seg{s}_{k}"] = np.asarray(v, wire)
    meta["nseg"] = nseg
    meta["sorted_by"] = sp.sorted_by
    _write_summary(ddir, meta)
    path = os.path.join(ddir, f"products.{h}.npz")
    np.savez(path, **arrays)
    return path


def read_dumps(params, directory="."):
    """Returns an FmaxResult-compatible object or raises on mismatch."""
    from ..fmax import FmaxResult, Products, Smoothing, SparseProducts
    from ..grids import Grid

    ddir = os.path.join(directory, DUMP_DIR)
    with open(os.path.join(ddir, "summary.json")) as fd:
        meta = json.load(fd)
    for key, want in (("GridSize", params.GridSize),
                      ("RandomSeed", params.RandomSeed),
                      ("BoxSize", params.BoxSize),
                      ("lpt_order", params.lpt_order)):
        if meta[key] != want:
            raise ValueError(f"dump mismatch for {key}: dump has "
                             f"{meta[key]}, run wants {want}")
    grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
    if "radii" in meta:
        sm = Smoothing(radii=np.asarray(meta["radii"]),
                       variance=np.asarray(meta["variance"]),
                       true_variance=np.asarray(meta["true_variance"]))
    else:
        sm = None                     # legacy dense dump: arrays in npz

    if meta.get("format", "dense") == "dense":
        import jax.numpy as jnp
        data = np.load(os.path.join(ddir, "products.npz"))
        vel = {k[4:]: jnp.asarray(data[k]) for k in data.files
               if k.startswith("vel_")}
        if sm is None:
            sm = Smoothing(radii=data["radii"],
                           variance=data["variance"],
                           true_variance=data["true_variance"])
        products = Products(Fmax=jnp.asarray(data["Fmax"]),
                            Rmax=jnp.asarray(data["Rmax"]), vel=vel)
        return FmaxResult(products=products, smoothing=sm, grid=grid,
                          kdensity=None, timings={})

    # ---- sparse chunked dump ----
    if params.WriteTimelessSnapshot:
        raise ValueError(
            "this dump is sparse (needed particles only) but the run "
            "wants a timeless snapshot, which needs the dense products; "
            "re-dump with WriteTimelessSnapshot=True")
    chunk_files = sorted(glob.glob(os.path.join(ddir, "products.*.npz")),
                         key=lambda p: int(p.rsplit(".", 2)[1]))
    if not chunk_files:
        raise FileNotFoundError(f"no dump chunks in {ddir}")
    chunks = [np.load(f) for f in chunk_files]
    vel_keys = sorted({k[4:] for c in chunks for k in c.files
                       if k.startswith("vel_")})
    nseg = int(meta.get("nseg", 0))
    ci = np.concatenate([c["ci"] for c in chunks])
    F = np.concatenate([c["F"] for c in chunks])
    # upcast f16 wire-dtype rows once here (the sweep reads f32)
    vel = {k: np.concatenate([c[f"vel_{k}"] for c in chunks])
           .astype(np.float32, copy=False) for k in vel_keys}
    segs = [{k: np.concatenate([c[f"seg{s}_{k}"] for c in chunks])
             .astype(np.float32, copy=False)
             for k in vel_keys if f"seg{s}_{k}" in chunks[0].files}
            for s in range(1, nseg)]
    sorted_by = meta.get("sorted_by", "ci")
    if len(chunks) > 1:
        # hosts' shares may overlap when mocked in one process: dedup by
        # cell and leave ascending-ci order
        order = np.argsort(ci, kind="stable")
        keep = np.ones(len(ci), bool)
        keep[1:] = ci[order][1:] != ci[order][:-1]
        idx = order[keep]
        ci, F = ci[idx], F[idx]
        vel = {k: v[idx] for k, v in vel.items()}
        segs = [{k: v[idx] for k, v in seg.items()} for seg in segs]
        sorted_by = "ci"
    sp = SparseProducts(N=grid.N, ci=ci, F=F, vel=vel,
                        sorted_by=sorted_by)
    products = Products(Fmax=None, Rmax=None, vel={})
    res = FmaxResult(products=products, smoothing=sm, grid=grid,
                     kdensity=None, host_products=sp, timings={})
    if nseg:
        res.vel_segments = [sp.vel] + segs
        res.seg_sparse = True
    return res
