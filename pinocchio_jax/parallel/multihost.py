"""Multi-host bring-up and per-host product staging.

The reference's process model is MPI_Init + hypercube point-to-point
product redistribution (pinocchio.c:41-52, distribute.c:58-175).  The
Analog here:

  * process bring-up = jax.distributed.initialize (one process per host,
    devices addressed locally, collectives ride NVLink within a host and
    the network across hosts);
  * product redistribution = each host materializes ONLY the shards held
    by its own chips (Array.addressable_shards), compacts them to the
    needed particles on the way out, and owns the fragmentation sub-boxes
    assigned to it round-robin — the hypercube exchange collapses to a
    per-host d2h fetch plus sub-box ownership, because sub-box sweeps
    never communicate (DOCUMENTATION:127-133).

Boundary-layer particles held by OTHER hosts' chips arrive through the
packed sparse all_to_all in parallel/exchange.py (the distribute.c:58-175
hypercube analog): fragment.subbox._host_copy runs it automatically
whenever the products are sharded over a multi-device mesh divisible into
host groups, and falls back to the per-shard local fetch below otherwise.
RECOMPUTE_DISPLACEMENTS segment sets are deferred on device
(run_fmax_distributed defer_segments, automatic for multi-process runs)
and routed by the same collective as extra row channels.  Each host
writes its outputs as .out.<host> chunks via a private staging directory;
scripts/merge_chunks.py reassembles them and recomputes the merged-only
products (mass functions, n(z)).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..backend import transfer_policy


def initialize_cluster(nhosts: int = None, coordinator: str = None,
                       process_id: int = None, verbose: bool = True):
    """jax.distributed bring-up (the MPI_Init_thread analog,
    pinocchio.c:41-52).  A no-op for single-process runs: returns the
    (host_id, nhosts) pair either way."""
    import jax
    if nhosts and nhosts > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=nhosts,
                                   process_id=process_id)
    hid, n = jax.process_index(), jax.process_count()
    if verbose and n > 1:
        print(f"[cluster] process {hid}/{n} up, "
              f"{jax.local_device_count()} local device(s)")
    return hid, n


def host_subboxes(geoms: list, host_id: int, nhosts: int) -> list:
    """Round-robin sub-box ownership (the analog of the reference's
    task<->sub-box assignment, initialization.c:995-1009)."""
    return geoms[host_id::nhosts]


def fetch_local_sparse(params, fmax_result,
                       device_filter: Callable = None,
                       f16: bool = None):
    """Per-host needed-particle compaction of the fmax products.

    Walks the addressable shards of Fmax and each displacement stack (on
    a multi-host mesh these are exactly the shards on this host's chips),
    keeps cells with Fmax >= Flast, and returns a SparseProducts whose
    cell indices are GLOBAL — the same structure fetch_products_host
    builds from a full gather, so fragmentation code is agnostic.

    device_filter(device) -> bool restricts the walk further; tests use
    it to mock an H-host cluster on one process (host h owning devices
    h::H) and check that the union over mocked hosts equals the full
    fetch.
    """
    import jax

    from ..fmax import SparseProducts

    prods = fmax_result.products
    N = fmax_result.grid.N
    Flast = np.float32(params.Flast)
    if f16 is None:
        f16 = transfer_policy(params)[1]

    # spatial index -> shard lookup for each velocity stack
    vel_shards: Dict[str, dict] = {}
    for k, v in prods.vel.items():
        vel_shards[k] = {}
        for sh in v.addressable_shards:
            vel_shards[k][_spatial_key(sh.index[-3:])] = sh

    ci_parts, F_parts = [], []
    vel_parts = {k: [] for k in prods.vel}
    for sh in prods.Fmax.addressable_shards:
        if device_filter is not None and not device_filter(sh.device):
            continue
        Fb = np.asarray(sh.data)
        sx, sy, sz = (sl.start or 0 for sl in sh.index[-3:])
        mask = Fb >= Flast
        if not mask.any():
            continue
        lx, ly, lz = np.nonzero(mask)
        ci_parts.append(((lx + sx).astype(np.int64) * N
                         + (ly + sy)) * N + (lz + sz))
        F_parts.append(Fb[mask])
        key = _spatial_key(sh.index[-3:])
        for k in prods.vel:
            vsh = vel_shards[k][key]
            vb = np.asarray(vsh.data)          # [3, nx, ny, nz]
            rows = vb[:, mask].T.astype(np.float32)
            vel_parts[k].append(np.asarray(
                rows.astype(np.float16), np.float32) if f16 else rows)

    if not ci_parts:
        return SparseProducts(N=N, ci=np.zeros(0, np.int64),
                              F=np.zeros(0, np.float32),
                              vel={k: np.zeros((0, 3), np.float32)
                                   for k in prods.vel})
    ci = np.concatenate(ci_parts)
    order = np.argsort(ci, kind="stable")
    return SparseProducts(
        N=N, ci=ci[order],
        F=np.concatenate(F_parts)[order],
        vel={k: np.concatenate(vel_parts[k])[order]
             for k in prods.vel})


def _spatial_key(index) -> tuple:
    return tuple((sl.start or 0, sl.stop) for sl in index)
