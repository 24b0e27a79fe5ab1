"""Regression tests for the >=512^3 scale paths.

Round-1 shipped two latent bugs on exactly the big-run configurations
(VERDICT.md round 1):
  (a) collapse_update accumulated the grid variance with a flat fp32 mean
      (ulp starvation made sigma(R) come out 16% low at 512^3);
  (b) the staged displacement branch (N >= STAGED_LPT_THRESHOLD) freed the
      Hessian before the RECOMPUTE_DISPLACEMENTS segment loop dereferenced
      it (TypeError on every big nu-run configuration).
Both paths are covered here at CPU-sized grids: the staged threshold is a
module constant the tests lower.
"""

import dataclasses

import numpy as np
import pytest


def test_collapse_stats_fp64_oracle():
    """d_avg / d_var from collapse_update must match a float64 reduction
    (collapse_times.c:656-670 accumulates in double; our fp32 path must
    use the hierarchical _safe_mean, not a flat mean)."""
    import jax.numpy as jnp
    from pinocchio_jax.ops import collapse

    rng = np.random.RandomState(7)
    N = 192
    # diagonal components with a small common offset: the delta field has
    # a non-zero mean, the regime where accumulator starvation showed up
    derivs = rng.standard_normal((6, N, N, N)).astype(np.float32) * 0.05
    derivs[:3] += 3e-3
    delta64 = derivs[:3].astype(np.float64).sum(axis=0)
    want_avg = delta64.mean()
    want_var = (delta64 ** 2).mean()

    Fmax0 = jnp.full((N, N, N), -10.0, jnp.float32)
    Rmax0 = jnp.full((N, N, N), -1, jnp.int32)

    class _FakeSpline:
        y = np.linspace(-3.0, 0.0, 64)      # log10 D
        x = np.linspace(-3.0, 0.0, 64)      # log10 a (EdS-like)

    pack = collapse.fit_inverse_growth(_FakeSpline.y, _FakeSpline.x)
    _, _, d_avg, d_var = collapse.collapse_update(
        jnp.asarray(derivs), Fmax0, Rmax0, jnp.int32(0),
        jnp.asarray(pack))
    assert abs(float(d_avg) / want_avg - 1.0) < 1e-3
    assert abs(float(d_var) / want_var - 1.0) < 1e-3

    # the TABULATED_CT variant shares the same stats contract
    from pinocchio_jax.ops import tabulated
    tab = jnp.zeros((tabulated.CT_NBINS_D, tabulated.CT_NBINS_XY,
                     tabulated.CT_NBINS_XY), jnp.float32)
    dv = jnp.asarray(tabulated.delta_sampling().astype(np.float32))
    aux = np.linspace(-tabulated.CT_RANGE_D, tabulated.CT_RANGE_D,
                      tabulated.AUX_N)
    idx_map = jnp.asarray(np.clip(
        np.searchsorted(np.asarray(dv), aux, side="right") - 1, 0,
        tabulated.CT_NBINS_D - 2).astype(np.int32))
    _, _, t_avg, t_var = collapse.collapse_update_table(
        jnp.asarray(derivs), Fmax0, Rmax0, jnp.int32(0), tab, dv,
        idx_map, jnp.float32(1.0))
    assert abs(float(t_avg) / want_avg - 1.0) < 1e-3
    assert abs(float(t_var) / want_var - 1.0) < 1e-3


@pytest.fixture
def _staged_threshold():
    """Lower the staged-displacement threshold for the duration of a test."""
    from pinocchio_jax import fmax as fmax_mod
    saved = fmax_mod.STAGED_LPT_THRESHOLD
    yield fmax_mod
    fmax_mod.STAGED_LPT_THRESHOLD = saved


def _run(params, cosmo, staged, fmax_mod, N):
    fmax_mod.STAGED_LPT_THRESHOLD = N if staged else N + 1
    return fmax_mod.run_fmax(params, cosmo, verbose=False)


def test_staged_path_matches_monolithic(hmf_validation_params,
                                        hmf_validation_cosmology,
                                        _staged_threshold):
    """The staged (per-field) displacement programs must reproduce the
    monolithic displacement_stage bit-for-bit-close."""
    N = 32
    p = dataclasses.replace(hmf_validation_params, GridSize=N)
    a = _run(p, hmf_validation_cosmology, False, _staged_threshold, N)
    b = _run(p, hmf_validation_cosmology, True, _staged_threshold, N)
    assert set(a.products.vel) == set(b.products.vel)
    for k in a.products.vel:
        np.testing.assert_allclose(np.asarray(a.products.vel[k]),
                                   np.asarray(b.products.vel[k]),
                                   rtol=2e-5, atol=1e-7)


def test_staged_recompute_displacements(hmf_validation_params,
                                        hmf_validation_cosmology,
                                        _staged_threshold):
    """RECOMPUTE_DISPLACEMENTS through the staged branch: round 1 crashed
    here (sd freed before the segment loop re-used it); now the segment
    loop rides the z-independent LPT source k-vectors."""
    N = 32
    p = dataclasses.replace(hmf_validation_params, GridSize=N,
                            recompute_displacements=True)
    assert len(p.output_z) > 1
    a = _run(p, hmf_validation_cosmology, False, _staged_threshold, N)
    b = _run(p, hmf_validation_cosmology, True, _staged_threshold, N)
    assert a.vel_segments is not None and b.vel_segments is not None
    assert len(a.vel_segments) == len(p.output_z) == len(b.vel_segments)
    for sa, sb in zip(a.vel_segments, b.vel_segments):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_allclose(sa[k], sb[k], rtol=2e-5, atol=1e-7)
    # segment 0 must be the products.vel set itself
    for k in a.vel_segments[0]:
        np.testing.assert_allclose(
            np.asarray(b.products.vel[k]), b.vel_segments[0][k],
            rtol=1e-6, atol=0)


def test_staged_sparse_fetch(hmf_validation_params,
                             hmf_validation_cosmology, _staged_threshold):
    """The >=512^3 staged path with sparse transfer: the compaction sort
    is deferred until the Hessian release, the dense stacks are freed as
    their rows are gathered, and the resolved sparse products drive a
    fragmentation identical to the dense run."""
    import dataclasses
    from pinocchio_jax.fmax import fetch_products_host, run_fmax
    from pinocchio_jax.fragment.driver import run_fragmentation
    N = 32
    base = dataclasses.replace(hmf_validation_params, GridSize=N,
                               transfer_f16=False)
    c = hmf_validation_cosmology
    _staged_threshold.STAGED_LPT_THRESHOLD = N     # force staged

    p_sparse = dataclasses.replace(base, sparse_transfer=True)
    r_sparse = run_fmax(p_sparse, c, verbose=False)
    assert r_sparse.pending_fetch is not None
    # dense stacks were freed on the way
    assert all(v is None for v in r_sparse.products.vel.values())
    r_sparse = fetch_products_host(p_sparse, r_sparse)

    p_dense = dataclasses.replace(base, sparse_transfer=False)
    r_dense = run_fmax(p_dense, c, verbose=False)

    f0 = run_fragmentation(p_dense, c, r_dense, verbose=False)
    f1 = run_fragmentation(p_sparse, c, r_sparse, verbose=False)
    assert np.array_equal(f0.counters, f1.counters)
    for c0, c1 in zip(f0.catalogs, f1.catalogs):
        assert np.array_equal(c0.name, c1.name)
        assert np.array_equal(c0.mass, c1.mass)
