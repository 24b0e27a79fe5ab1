"""Cross-chip / cross-host product redistribution: a packed sparse
all_to_all over the device mesh.

The analog of the reference's hypercube point-to-point exchange
(distribute.c:58-175): after the fmax stage the per-particle products live
in the FFT domain decomposition (x- or xy-sharded over the mesh), but
fragmentation sub-boxes are assigned to hosts (parallel/multihost.py), and
a sub-box's padded volume (boundary layers included) generally spans
shards owned by OTHER hosts.  Instead of point-to-point MPI sends, one
jitted shard_map program per exchange:

  1. each shard selects its needed particles (Fmax >= Flast — the V5
     needed-particle cut, distribute.c:670-698) that fall inside any
     destination host's sub-box regions;
  2. packs them (global coordinates + Fmax + displacement rows, optionally
     float16 on the wire) into fixed-capacity per-destination-device
     buffers, load-balanced round-robin over the destination host's
     devices;
  3. routes everything with `jax.lax.all_to_all` — one tiled collective on
     a slab mesh, two subgroup collectives (rows then columns) on a pencil
     mesh — NVLink within a host, the network across hosts;
  4. each host then materializes ONLY its own devices' post-exchange
     shards (addressable on that host by construction) into the same
     SparseProducts structure the rest of the fragmentation stack
     consumes.

The buffer capacity is measured by a tiny replicated counting program
first (one scalar crosses the link), then bucketed so the packing program
recompiles at most a handful of times per grid.

A cell needed by two hosts is sent to both (the reference's belongs_to_Q
multi-destination case, distribute.c:280-307); within one host it is sent
exactly once, because membership is OR-reduced over that host's sub-boxes
before packing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..backend import transfer_policy
from . import pfft


def build_host_regions(geoms, nhosts: int, N: int,
                       turn0: bool = False) -> Tuple:
    """Per-host union-of-boxes selection regions from the sub-box
    geometries: host h owns geoms[h::nhosts] (multihost.host_subboxes) and
    needs each one's FULL padded volume [stabl, stabl+Lgwbl) per dim,
    wrapped mod N (initialization.c:1011-1057 geometry).

    turn0: the first-turn map instead — only the well-resolved region
    plus a 1-cell rim per non-periodic dim (create_map,
    fragment.c:708-751), the wire analog of subbox.turn0_bounds."""
    regions = []
    for h in range(nhosts):
        boxes = []
        for g in geoms[h::nhosts]:
            box = []
            for d in range(3):
                if turn0 and not g.pbc[d]:
                    lo = max(0, int(g.safe[d]) - 1)
                    hi = min(int(g.L[d]), int(g.L[d]) - int(g.safe[d]) + 1)
                    box.append(((int(g.stabl[d]) + lo) % N, hi - lo))
                else:
                    box.append((int(g.stabl[d]) % N, int(g.L[d])))
            boxes.append(tuple(box))
        regions.append(tuple(boxes))
    return tuple(regions)


def _np_member(boxes, gx, gy, gz, N):
    """Host-side (numpy) analog of _member."""
    m = np.zeros((len(gx), len(gy), len(gz)), bool)
    for (x0, lx), (y0, ly), (z0, lz) in boxes:
        m |= (((gx - x0) % N < lx)[:, None, None]
              & ((gy - y0) % N < ly)[None, :, None]
              & ((gz - z0) % N < lz)[None, None, :])
    return m


def _paint_block(spheres_h, padded_boxes, t0_boxes, N, xsl, ysl, zsl):
    """Paint one shard block [nx,ny,nz] uint8 of host h's turn-1 request
    map: the union of boundary spheres around its quick-pass halos
    (update_map, build_groups.c:2246-2318), clipped to its padded sub-box
    volumes and excluding cells already shipped in turn 0."""
    nx = xsl.stop - xsl.start
    ny = ysl.stop - ysl.start
    nz = zsl.stop - zsl.start
    out = np.zeros((nx, ny, nz), np.uint8)
    for cx, cy, cz, s in np.asarray(spheres_h, np.float64):
        s = int(s)
        if s <= 0:
            continue
        off = np.arange(-s, s)
        gx = (int(cx) + off) % N
        gy = (int(cy) + off) % N
        gz = (int(cz) + off) % N
        lx = gx - xsl.start
        ly = gy - ysl.start
        lz = gz - zsl.start
        inx = (lx >= 0) & (lx < nx)
        iny = (ly >= 0) & (ly < ny)
        inz = (lz >= 0) & (lz < nz)
        if not (inx.any() and iny.any() and inz.any()):
            continue
        sel = (off[:, None, None] ** 2 + off[None, :, None] ** 2
               + off[None, None, :] ** 2 <= s * s)
        sel &= inx[:, None, None] & iny[None, :, None] & inz[None, None, :]
        sel &= _np_member(padded_boxes, gx, gy, gz, N)
        sel &= ~_np_member(t0_boxes, gx, gy, gz, N)
        i, j, k = np.nonzero(sel)
        out[lx[i], ly[j], lz[k]] = 1
    return out


def build_turn1_maps(spheres, geoms, nhosts, N, mesh, decomp):
    """Device request maps [nhosts, N, N, N] uint8 sharded like the
    products' real-space layout.  Each process paints only its own
    devices' shard blocks (make_array_from_callback), so the maps never
    materialize globally; `spheres` is {host: [ns,4] float32 of global
    (cx,cy,cz,radius_cells)} — small, allgathered across processes by the
    caller (the frag_map_update bitmap of distribute.c:689-698 becomes a
    sphere list on the wire)."""
    padded = build_host_regions(geoms, nhosts, N)
    t0 = build_host_regions(geoms, nhosts, N, turn0=True)
    spec = P(None, *decomp.real_spec)
    sharding = jax.sharding.NamedSharding(mesh, spec)

    def cb(index):
        hsl, xsl, ysl, zsl = index
        blocks = []
        for h in range(nhosts):
            sph = spheres.get(h)
            if sph is None or len(sph) == 0:
                nx = xsl.stop - xsl.start
                ny = ysl.stop - ysl.start
                blocks.append(np.zeros((nx, ny, N), np.uint8))
            else:
                blocks.append(_paint_block(sph, padded[h], t0[h], N,
                                           xsl, ysl, zsl))
        return np.stack(blocks)

    def norm(index):
        # normalize the per-shard global index to concrete slices
        hsl, xsl, ysl, zsl = index
        fix = lambda sl, n: slice(sl.start or 0, sl.stop if sl.stop  # noqa
                                  is not None else n)
        return (fix(hsl, nhosts), fix(xsl, N), fix(ysl, N), fix(zsl, N))

    return jax.make_array_from_callback(
        (nhosts, N, N, N), sharding, lambda idx: cb(norm(idx)))


def merge_sparse(a, b):
    """Union of two disjoint SparseProducts (turn 0 + turn 1), re-sorted
    by ascending cell index (the layout sub-box loading expects)."""
    if b is None or len(b.ci) == 0:
        return a
    if len(a.ci) == 0:
        return b
    import dataclasses
    ci = np.concatenate([a.ci, b.ci])
    order = np.argsort(ci, kind="stable")
    merge_rows = lambda x, y: np.concatenate([x, y])[order]  # noqa: E731
    segs = None
    if a.segments is not None:
        segs = [{k: merge_rows(sa[k], sb[k]) for k in sa}
                for sa, sb in zip(a.segments, b.segments)]
    return dataclasses.replace(
        a, ci=ci[order],
        F=np.concatenate([a.F, b.F])[order],
        vel={k: merge_rows(a.vel[k], b.vel[k]) for k in a.vel},
        segments=segs, sorted_by="ci")


def host_of_device_default(mesh: Mesh, nhosts: int):
    """Flat-mesh-index -> host map.  On a real cluster this is the
    process index of each device; single-process tests mock an H-host
    cluster as contiguous blocks of the flat device order (the layout
    jax.distributed produces: each host's chips are consecutive)."""
    devs = list(mesh.devices.flat)
    p = len(devs)
    if any(d.process_index for d in devs):
        return tuple(d.process_index for d in devs)
    dph = p // nhosts
    assert dph * nhosts == p, "nhosts must divide the mesh size"
    return tuple(i // dph for i in range(p))


def _member(boxes, gx, gy, gz, N):
    """[nx,ny,nz] bool: cell inside any of the host's wrapped boxes."""
    m = None
    for (x0, lx), (y0, ly), (z0, lz) in boxes:
        bm = (((gx - x0) % N < lx)[:, None, None]
              & ((gy - y0) % N < ly)[None, :, None]
              & ((gz - z0) % N < lz)[None, None, :])
        m = bm if m is None else (m | bm)
    if m is None:
        m = jnp.zeros((gx.shape[0], gy.shape[0], gz.shape[0]), bool)
    return m


def _shard_coords(decomp, N):
    """Global coordinate vectors for this shard's block."""
    if isinstance(decomp, pfft.PencilDecomp):
        a = jax.lax.axis_index(pfft.AXA)
        b = jax.lax.axis_index(pfft.AXB)
        nx, ny = N // decomp.pa, N // decomp.pb
        gx = a * nx + jnp.arange(nx, dtype=jnp.int32)
        gy = b * ny + jnp.arange(ny, dtype=jnp.int32)
    else:
        me = jax.lax.axis_index(pfft.AX)
        nx = N // decomp.p
        gx = me * nx + jnp.arange(nx, dtype=jnp.int32)
        gy = jnp.arange(N, dtype=jnp.int32)
    gz = jnp.arange(N, dtype=jnp.int32)
    return gx, gy, gz


def _route(decomp, buf):
    """Tiled all_to_all(s): buf leading dim indexes the destination's
    flat mesh position; afterwards it indexes the SOURCE's."""
    if isinstance(decomp, pfft.PencilDecomp):
        pa, pb = decomp.pa, decomp.pb
        buf = buf.reshape((pa, pb) + buf.shape[1:])
        buf = jax.lax.all_to_all(buf, pfft.AXA, split_axis=0,
                                 concat_axis=0, tiled=True)
        buf = jax.lax.all_to_all(buf, pfft.AXB, split_axis=1,
                                 concat_axis=1, tiled=True)
        return buf.reshape((pa * pb,) + buf.shape[2:])
    return jax.lax.all_to_all(buf, pfft.AX, split_axis=0,
                              concat_axis=0, tiled=True)


_CAP_BUCKETS = 16


def exchange_products(params, fmax_result, mesh: Mesh, geoms,
                      nhosts: int, host_of_device=None, f16: bool = None,
                      verbose: bool = False, turn: int = None,
                      spheres: Dict[int, np.ndarray] = None,
                      ) -> Dict[int, "SparseProducts"]:
    """Run the exchange; return {host_id: SparseProducts} for every host
    whose post-exchange shards are addressable from this process (on a
    real cluster: exactly this host; in single-process tests: all).

    When fmax_result.vel_segments_dev is set (RECOMPUTE_DISPLACEMENTS on
    a deferred-segment distributed run), the per-segment displacement
    stacks are routed as additional row channels and come back in each
    host's SparseProducts.segments, aligned row-for-row with .vel.

    turn selects the V5 two-turn wire protocol (fragment.c:159-316):
    None = single turn, ship the FULL padded volumes (the round-2
    default); 0 = ship only each host's well-resolved regions + 1-cell
    rim; 1 = ship only the cells in `spheres` ({host: [ns,4] global
    (cx,cy,cz,r)} boundary spheres around quick-pass halos), clipped to
    the padded volumes and excluding the turn-0 cells."""
    import time

    from ..fmax import SparseProducts

    t0 = time.perf_counter()
    prods = fmax_result.products
    N = fmax_result.grid.N
    decomp = pfft.make_decomp(mesh, N)
    p = mesh.devices.size
    Flast = float(params.Flast)
    if f16 is None:
        f16 = transfer_policy(params)[1]
    regions = build_host_regions(geoms, nhosts, N, turn0=(turn == 0))
    maps = None
    if turn == 1:
        maps = build_turn1_maps(spheres or {}, geoms, nhosts, N, mesh,
                                decomp)
    if host_of_device is None:
        host_of_device = host_of_device_default(mesh, nhosts)
    host_devs = tuple(
        tuple(i for i in range(p) if host_of_device[i] == h)
        for h in range(nhosts))
    assert all(host_devs), "every host needs at least one mesh device"
    keys = sorted(prods.vel)
    # row-table channels: the displacement stacks, plus one channel per
    # (segment, stack) when segments are still on device
    seg_dev = getattr(fmax_result, "vel_segments_dev", None)
    channels = [("v", k) for k in keys]
    tables = [prods.vel[k] for k in keys]
    if seg_dev:
        for s, vs in enumerate(seg_dev):
            if vs is None:
                continue               # segment 0 aliases the 'v' channels
            for k in sorted(vs):
                channels.append(("s", s, k))
                tables.append(vs[k])
    real_spec = decomp.real_spec
    vel_spec = P(None, *real_spec)

    map_spec = P(None, *real_spec)

    def _membership(h, gx, gy, gz, M):
        if M is not None:
            return M[h] > 0
        return _member(regions[h], gx, gy, gz, N)

    # ---- 1. capacity: replicated max over (shard, host) of the count
    def count_local(F, *M):
        M = M[0] if M else None
        gx, gy, gz = _shard_coords(decomp, N)
        needed = F >= Flast
        cs = [jnp.sum(needed & _membership(h, gx, gy, gz, M))
              for h in range(nhosts)]
        c = jnp.max(jnp.stack(cs))
        for ax in mesh.axis_names:
            c = jax.lax.pmax(c, ax)
        return c

    count_ops = (prods.Fmax,) + ((maps,) if maps is not None else ())
    count_specs = (real_spec,) + ((map_spec,) if maps is not None else ())
    cmax = int(np.asarray(pfft.shard_map_fn(
        mesh, count_local, count_specs, P())(*count_ops)))
    t_count = time.perf_counter() - t0
    # per-destination-device slot count, bucketed for program reuse
    dph_min = min(len(d) for d in host_devs)
    shard_cells = (N // decomp.pa) * (N // decomp.pb) * N \
        if isinstance(decomp, pfft.PencilDecomp) \
        else (N // decomp.p) * N * N
    step = max(1, shard_cells // (_CAP_BUCKETS * dph_min))
    c2 = max(1, -(-cmax // dph_min))
    c2 = min(shard_cells, -(-c2 // step) * step)

    # ---- 2. pack + route (one device program)
    wire = jnp.float16 if f16 else jnp.float32

    def pack_local(F, *ops):
        if maps is not None:
            M, vels = ops[0], ops[1:]
        else:
            M, vels = None, ops
        gx, gy, gz = _shard_coords(decomp, N)
        nx, ny, nz = gx.shape[0], gy.shape[0], gz.shape[0]
        needed = (F >= Flast).ravel()
        cap = p * c2
        bx = jnp.full((cap,), -1, jnp.int32)
        byz = jnp.zeros((cap,), jnp.int32)
        bF = jnp.zeros((cap,), wire)
        bV = [jnp.zeros((cap, 3), wire) for _ in channels]
        gxf = jnp.broadcast_to(gx[:, None, None], (nx, ny, nz)).ravel()
        gyzf = jnp.broadcast_to((gy[:, None] * N + gz[None, :])[None],
                                (nx, ny, nz)).ravel()
        Ff = F.ravel().astype(wire)
        vrows = [v.reshape(3, -1).T.astype(wire) for v in vels]
        for h in range(nhosts):
            m = (_membership(h, gx, gy, gz, M).ravel() & needed)
            i = jnp.cumsum(m.astype(jnp.int32)) - 1
            devs = jnp.asarray(host_devs[h], jnp.int32)
            pos = jnp.where(
                m, devs[i % len(host_devs[h])] * c2
                + i // len(host_devs[h]), cap)
            bx = bx.at[pos].set(gxf, mode="drop")
            byz = byz.at[pos].set(gyzf, mode="drop")
            bF = bF.at[pos].set(Ff, mode="drop")
            for j in range(len(channels)):
                bV[j] = bV[j].at[pos].set(vrows[j], mode="drop")
        out = [b.reshape(p, c2) for b in (bx, byz, bF)]
        out += [b.reshape(p, c2, 3) for b in bV]
        return tuple(_route(decomp, b) for b in out)

    lead = (mesh.axis_names[0] if len(mesh.axis_names) == 1
            else tuple(mesh.axis_names))
    out_specs = tuple([P(lead, None)] * 3
                      + [P(lead, None, None)] * len(channels))
    pack_ops = (prods.Fmax,) + ((maps,) if maps is not None else ()) \
        + tuple(tables)
    pack_specs = (real_spec,) + ((map_spec,) if maps is not None else ()) \
        + (vel_spec,) * len(channels)
    t1 = time.perf_counter()
    packed = pfft.shard_map_fn(
        mesh, pack_local, pack_specs, out_specs)(*pack_ops)
    jax.block_until_ready(packed)
    t_pack = time.perf_counter() - t1

    # ---- 3. per-host extraction from addressable shards
    t1 = time.perf_counter()
    dev_pos = {id(d): i for i, d in enumerate(mesh.devices.flat)}
    per_dev: Dict[int, list] = {}
    for qi, q in enumerate(packed):
        for sh in q.addressable_shards:
            per_dev.setdefault(dev_pos[id(sh.device)],
                               [None] * len(packed))[qi] = np.asarray(
                                   sh.data)

    out: Dict[int, SparseProducts] = {}
    for h in range(nhosts):
        ci_parts, F_parts = [], []
        v_parts = {c: [] for c in channels}
        got = False
        for d in host_devs[h]:
            if d not in per_dev:
                continue
            got = True
            bx, byz, bF = per_dev[d][0], per_dev[d][1], per_dev[d][2]
            valid = bx.ravel() >= 0
            if not valid.any():
                continue
            x = bx.ravel()[valid].astype(np.int64)
            yz = byz.ravel()[valid].astype(np.int64)
            ci_parts.append(x * N * N + yz)
            F_parts.append(bF.reshape(-1)[valid].astype(np.float32))
            for j, c in enumerate(channels):
                v_parts[c].append(
                    per_dev[d][3 + j].reshape(-1, 3)[valid]
                    .astype(np.float32))
        if not got:
            continue
        if ci_parts:
            ci = np.concatenate(ci_parts)
            order = np.argsort(ci, kind="stable")
            rows = {c: np.concatenate(v_parts[c])[order]
                    for c in channels}
        else:
            ci = np.zeros(0, np.int64)
            order = np.zeros(0, np.int64)
            rows = {c: np.zeros((0, 3), np.float32) for c in channels}
        segs = None
        if seg_dev:
            segs = [({k: rows[("v", k)] for k in keys} if vs is None
                     else {k: rows[("s", s2, k)] for k in sorted(vs)})
                    for s2, vs in enumerate(seg_dev)]
        out[h] = SparseProducts(
            N=N, ci=ci[order] if len(ci) else ci,
            F=(np.concatenate(F_parts)[order] if len(ci)
               else np.zeros(0, np.float32)),
            vel={k: rows[("v", k)] for k in keys},
            segments=segs)
    t_extract = time.perf_counter() - t1
    if verbose:
        tot = sum(len(s.ci) for s in out.values())
        lab = "" if turn is None else f" turn {turn}:"
        print(f"  exchange:{lab} cap {c2}/dev-slot x {p} devices, "
              f"{tot} particle-copies delivered in "
              f"{time.perf_counter() - t0:.1f}s "
              f"(count {t_count:.1f} + device pack+route {t_pack:.1f} "
              f"+ host extract {t_extract:.1f}) — the constant is the "
              f"device pack program + d2h, not a python pack loop")
    return out
