"""Cross-host product redistribution (parallel/exchange): the packed
sparse all_to_all that replaces the reference's hypercube point-to-point
exchange (distribute.c:58-175), unit-tested with mocked host groups on
the 8-device CPU mesh."""

import dataclasses

import numpy as np
import pytest


@pytest.fixture(scope="module")
def sharded64(hmf_validation_params, hmf_validation_cosmology):
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    p = dataclasses.replace(hmf_validation_params, GridSize=64)
    res = run_fmax_distributed(p, hmf_validation_cosmology,
                               pfft.make_pencil_mesh(8), verbose=False)
    return p, res


def _geoms(params, cosmo, ntasks):
    from pinocchio_jax.fragment.subbox import (choose_nbox,
                                               subbox_geometries)
    from pinocchio_jax.io.catalogs import largest_halo_mass
    largest = largest_halo_mass(params, cosmo)
    nbox = choose_nbox(params, cosmo, largest, ntasks)
    return subbox_geometries(params, cosmo, largest, nbox), nbox


def _expected_host_set(params, res, geoms, nhosts, h):
    """Brute force: every needed cell inside any of host h's padded
    sub-box volumes, from the gathered global arrays."""
    N = res.grid.N
    F = np.asarray(res.products.Fmax)
    coord = np.arange(N)
    member = np.zeros((N, N, N), bool)
    for g in geoms[h::nhosts]:
        ms = []
        for d in range(3):
            ms.append((coord - g.stabl[d]) % N < g.L[d])
        member |= (ms[0][:, None, None] & ms[1][None, :, None]
                   & ms[2][None, None, :])
    want = member & (F >= params.Flast)
    ci = np.flatnonzero(want.ravel()).astype(np.int64)
    return ci, F.ravel()[ci]


@pytest.mark.parametrize("nhosts", [2, 4])
def test_exchange_matches_bruteforce(sharded64, hmf_validation_cosmology,
                                     nhosts):
    from pinocchio_jax.parallel.exchange import exchange_products
    p, res = sharded64
    geoms, _ = _geoms(p, hmf_validation_cosmology, 4)
    mesh = res.products.Fmax.sharding.mesh
    out = exchange_products(p, res, mesh, geoms, nhosts, f16=False)
    assert sorted(out) == list(range(nhosts))
    v1 = np.asarray(res.products.vel["v1"]).reshape(3, -1)
    for h in range(nhosts):
        ci, F = _expected_host_set(p, res, geoms, nhosts, h)
        sp = out[h]
        np.testing.assert_array_equal(sp.ci, ci)
        np.testing.assert_allclose(sp.F, F, rtol=0, atol=0)
        np.testing.assert_allclose(sp.vel["v1"], v1[:, ci].T,
                                   rtol=0, atol=0)


def test_exchange_slab_mesh(sharded64, hmf_validation_params,
                            hmf_validation_cosmology):
    """The slab (1-D mesh) routing path delivers the same sets."""
    import jax
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.exchange import exchange_products
    p, res = sharded64
    geoms, _ = _geoms(p, hmf_validation_cosmology, 4)
    mesh = pfft.make_mesh(8)
    decomp = pfft.make_decomp(mesh, res.grid.N)
    # re-lay the products on the slab mesh
    reput = lambda a, s: jax.device_put(np.asarray(a), s)  # noqa: E731
    prods = dataclasses.replace(
        res.products,
        Fmax=reput(res.products.Fmax, decomp.real_sharding()),
        vel={k: reput(v, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, pfft.AX, None, None)))
            for k, v in res.products.vel.items()})
    res2 = dataclasses.replace(res, products=prods)
    out = exchange_products(p, res2, mesh, geoms, 2, f16=False)
    for h in range(2):
        ci, F = _expected_host_set(p, res, geoms, 2, h)
        np.testing.assert_array_equal(out[h].ci, ci)
        np.testing.assert_allclose(out[h].F, F)


def test_multibox_exchange_catalog_union(sharded64,
                                         hmf_validation_cosmology):
    """Host-sliced fragmentation fed by the exchange must reproduce the
    single-process multibox catalogs exactly."""
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox
    from pinocchio_jax.io.catalogs import largest_halo_mass
    p, res = sharded64
    c = hmf_validation_cosmology
    largest = largest_halo_mass(p, c)
    geoms, nbox = _geoms(p, c, 4)
    full = run_fragmentation_multibox(p, c, res, nbox,
                                      largest_mass=largest, verbose=False)
    names, masses = [], []
    for h in range(2):
        part = run_fragmentation_multibox(
            p, c, res, nbox, largest_mass=largest,
            host_slice=(h, 2), verbose=False)
        names.append(part.catalogs[-1].name)
        masses.append(part.catalogs[-1].mass)
    union = np.concatenate(names)
    assert len(np.unique(union)) == len(union)
    np.testing.assert_array_equal(np.sort(union),
                                  np.sort(full.catalogs[-1].name))
    o_full = np.argsort(full.catalogs[-1].name)
    o_un = np.argsort(union)
    np.testing.assert_array_equal(np.concatenate(masses)[o_un],
                                  full.catalogs[-1].mass[o_full])


def test_exchange_routes_recompute_segments(hmf_validation_params,
                                            hmf_validation_cosmology):
    """RECOMPUTE_DISPLACEMENTS on a deferred-segment distributed run: the
    exchange routes every segment's displacement rows, and host-sliced
    fragmentation matches the single-process run exactly."""
    from pinocchio_jax.parallel import pfft
    from pinocchio_jax.parallel.driver import run_fmax_distributed
    from pinocchio_jax.parallel.exchange import exchange_products
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox
    from pinocchio_jax.io.catalogs import largest_halo_mass

    p = dataclasses.replace(hmf_validation_params, GridSize=64,
                            recompute_displacements=True,
                            transfer_f16=False)
    assert len(p.output_z) > 1
    c = hmf_validation_cosmology
    res = run_fmax_distributed(p, c, pfft.make_pencil_mesh(8),
                               verbose=False, defer_segments=True)
    assert res.vel_segments is None and res.vel_segments_dev is not None
    geoms, nbox = _geoms(p, c, 4)

    # routed segment rows equal the direct per-host selection
    out = exchange_products(p, res, res.products.Fmax.sharding.mesh,
                            geoms, 2, f16=False)
    for h in range(2):
        sp = out[h]
        assert sp.segments is not None and len(sp.segments) == \
            len(p.output_z)
        seg1 = np.asarray(res.vel_segments_dev[1]["v1"]).reshape(3, -1)
        np.testing.assert_array_equal(sp.segments[1]["v1"],
                                      seg1[:, sp.ci].T)

    # end-to-end: host-sliced catalogs == single-process catalogs (the
    # baseline run fetches segments to host, the sliced runs route them)
    largest = largest_halo_mass(p, c)
    res_full = run_fmax_distributed(p, c, pfft.make_pencil_mesh(8),
                                    verbose=False, defer_segments=False)
    full = run_fragmentation_multibox(p, c, res_full, nbox,
                                      largest_mass=largest, verbose=False)
    names = []
    for h in range(2):
        part = run_fragmentation_multibox(
            p, c, res, nbox, largest_mass=largest,
            host_slice=(h, 2), verbose=False)
        names.append(part.catalogs[-1].name)
    union = np.concatenate(names)
    np.testing.assert_array_equal(np.sort(union),
                                  np.sort(full.catalogs[-1].name))


def test_two_turn_exchange_catalog_union(sharded64,
                                         hmf_validation_cosmology):
    """The two-turn WIRE protocol (turn-0 resolved regions -> quick
    sweeps -> sphere-selected turn-1) must reproduce the local two-turn
    multibox catalogs exactly while shipping fewer particle-copies than
    the single-turn padded-volume exchange."""
    from pinocchio_jax.fragment.subbox import run_fragmentation_multibox
    from pinocchio_jax.io.catalogs import largest_halo_mass
    from pinocchio_jax.parallel.exchange import exchange_products
    p, res = sharded64
    c = hmf_validation_cosmology
    largest = largest_halo_mass(p, c)
    geoms, nbox = _geoms(p, c, 4)

    # baseline: single-process local two-turn sweep over all sub-boxes
    full = run_fragmentation_multibox(p, c, res, nbox,
                                      largest_mass=largest,
                                      two_turn=True, verbose=False)
    names, masses, shipped = [], [], 0
    for h in range(2):
        part = run_fragmentation_multibox(
            p, c, res, nbox, largest_mass=largest, two_turn=True,
            host_slice=(h, 2), verbose=False)
        names.append(part.catalogs[-1].name)
        masses.append(part.catalogs[-1].mass)
        shipped += part.nstored

    union = np.concatenate(names)
    assert len(np.unique(union)) == len(union)
    np.testing.assert_array_equal(np.sort(union),
                                  np.sort(full.catalogs[-1].name))
    o_full = np.argsort(full.catalogs[-1].name)
    o_un = np.argsort(union)
    np.testing.assert_array_equal(np.concatenate(masses)[o_un],
                                  full.catalogs[-1].mass[o_full])

    # the wire carries fewer copies than the padded-volume exchange
    mesh = res.products.Fmax.sharding.mesh
    single = exchange_products(p, res, mesh, geoms, 2, f16=False)
    padded_copies = sum(len(single[h].ci) for h in range(2))
    out0 = exchange_products(p, res, mesh, geoms, 2, turn=0, f16=False)
    turn0_copies = sum(len(out0[h].ci) for h in range(2))
    assert turn0_copies < padded_copies


@pytest.mark.slow
def test_exchange_scaling_16_hosts():
    """16 mocked hosts on a 16-device mesh (subprocess: the conftest pins
    8 devices): the union property holds at 16 hosts and the pack time
    grows sub-linearly in the host count — the per-host membership pass
    is O(nhosts x cells) worst-case (like the reference's per-destination
    hypercube passes, distribute.c:280-307), but the scatters that
    dominate are host-count-independent (VERDICT r3 item 8)."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "scripts/exp_exchange_scaling.py", "--grid", "64"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True,
        timeout=1200)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    data = json.loads(line[len("RESULT "):])
    rows = {row["nhosts"]: row for row in data["rows"]}
    assert set(rows) == {2, 4, 8, 16}
    for row in rows.values():
        assert row["delivered"] > 0
    # measured curve (RESULTS.md): pack+deliver time tracks DELIVERED
    # particle-copies (boundary duplication grows with the host count),
    # sublinear in hosts: 8x hosts -> 5.7x time / 7.8x copies at 64^3.
    # Bound generously — the 2 shared vCPUs jitter +-30%.
    per_copy_2 = rows[2]["pack_s"] / rows[2]["delivered"]
    per_copy_16 = rows[16]["pack_s"] / rows[16]["delivered"]
    assert per_copy_16 < 3.0 * max(per_copy_2, 1e-6), rows
