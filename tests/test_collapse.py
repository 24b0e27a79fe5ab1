"""Collapse kernel vs an independent float64 implementation of the same
math contract (collapse_times.c:114-221, 679-776)."""

import numpy as np
import pytest

SMALL = 1e-20


def eigen_ref(d):
    """float64 eigenvalues via numpy's symmetric solver, descending."""
    M = np.array([[d[0], d[3], d[4]],
                  [d[3], d[1], d[5]],
                  [d[4], d[5], d[2]]])
    return np.sort(np.linalg.eigvalsh(M))[::-1]


def ell_classic_ref(l1, l2, l3):
    """Straight float64 transcription of the branch structure."""
    delta = l1 + l2 + l3
    det = l1 * l2 * l3
    if abs(l1) < SMALL:
        ell = -0.1
    else:
        den = det / 126.0 + 5.0 * l1 * delta * (delta - l1) / 84.0
        if abs(den) < SMALL:
            if abs(delta - l1) < SMALL:
                ell = 1.0 / l1 if l1 > 0 else -0.1
            else:
                dis = 7.0 * l1 * (l1 + 6.0 * delta)
                if dis < 0:
                    ell = -0.1
                else:
                    ell = (7.0 * l1 - np.sqrt(dis)) / (3.0 * l1 * (l1 - delta))
                    if ell < 0:
                        ell = -0.1
        else:
            a1 = 3.0 * l1 * (delta - l1) / 14.0 / den
            a2 = l1 / den
            a3 = -1.0 / den
            q = (a1 * a1 - 3 * a2) / 9.0
            r = (2 * a1 ** 3 - 9 * a1 * a2 + 27 * a3) / 54.0
            rq = r * r - q ** 3
            if rq > 0:
                sq = (np.sqrt(rq) + abs(r)) ** (1.0 / 3.0)
                ell = -abs(r) / r * (sq + q / sq) - a1 / 3.0
                if ell < 0:
                    ell = -0.1
            else:
                sq = 2 * np.sqrt(q)
                t = np.arccos(2 * r / q / sq)
                ss = [-sq * np.cos((t + 2 * np.pi * i) / 3.0) - a1 / 3.0
                      for i in range(3)]
                ss = [s if s >= 0 else 1e10 for s in ss]
                ell = min(ss)
                if ell == 1e10:
                    ell = -0.1
    if delta > 0 and ell > 0:
        ell += (-0.364 / delta
                * np.exp(-6.5 * (l1 - l2) / delta - 2.8 * (l2 - l3) / delta))
    return ell


@pytest.fixture(scope="module")
def random_tensors():
    rng = np.random.default_rng(12345)
    # Hessian components with realistic amplitude (sigma ~ 0.3 - 3)
    return rng.normal(0.0, 1.0, size=(4000, 6))


def test_eigenvalues_match_numpy(random_tensors):
    import jax.numpy as jnp
    from pinocchio_jax.ops.collapse import eigenvalues_descending
    d = random_tensors
    l1, l2, l3, fail = eigenvalues_descending(
        jnp.asarray(d.T, jnp.float32))
    l1, l2, l3 = map(np.asarray, (l1, l2, l3))
    ref = np.array([eigen_ref(row) for row in d])
    ok = ~np.asarray(fail)
    assert ok.mean() > 0.999
    np.testing.assert_allclose(l1[ok], ref[ok, 0], atol=2e-4)
    np.testing.assert_allclose(l2[ok], ref[ok, 1], atol=2e-4)
    np.testing.assert_allclose(l3[ok], ref[ok, 2], atol=2e-4)


def test_ell_classic_matches_reference_impl(random_tensors):
    import jax.numpy as jnp
    from pinocchio_jax.ops.collapse import ell_classic
    ref_l = np.sort(random_tensors[:, :3], axis=1)[:, ::-1]
    mine = np.asarray(ell_classic(jnp.asarray(ref_l[:, 0], jnp.float32),
                                  jnp.asarray(ref_l[:, 1], jnp.float32),
                                  jnp.asarray(ref_l[:, 2], jnp.float32)))
    want = np.array([ell_classic_ref(*row) for row in ref_l])
    # exclude the catastrophic-cancellation manifold of den (fp32 cannot
    # resolve det/126 ~ -5 l1 del (del-l1)/84); those lambdas get a slightly
    # perturbed b_c, which is statistically invisible (see test_fmax.py)
    l1, l2, l3 = ref_l[:, 0], ref_l[:, 1], ref_l[:, 2]
    delta = l1 + l2 + l3
    t1 = l1 * l2 * l3 / 126.0
    t2 = 5.0 * l1 * delta * (delta - l1) / 84.0
    den = t1 + t2
    cond = np.abs(den) / (np.abs(t1) + np.abs(t2) + 1e-30)
    # also exclude near-degenerate cubic discriminants (acos near +-1
    # amplifies fp32 rounding)
    with np.errstate(divide="ignore", invalid="ignore"):
        a1 = 3 * l1 * (delta - l1) / 14.0 / den
        a2 = l1 / den
        a3 = -1.0 / den
        q = (a1 * a1 - 3 * a2) / 9.0
        r = (2 * a1 ** 3 - 9 * a1 * a2 + 27 * a3) / 54.0
        disc_cond = np.abs(r * r - q ** 3) / (r * r + np.abs(q) ** 3 + 1e-30)
    ok = (cond > 3e-2) & (disc_cond > 3e-2)
    both = (mine > 0) & (want > 0) & ok
    agree_sign = ((mine > 0) == (want > 0))[ok].mean()
    assert agree_sign > 0.995
    np.testing.assert_allclose(mine[both], want[both], rtol=2e-3, atol=2e-3)
    # globally (no conditioning filter), >=99.5% agree within 2%
    close = np.abs(mine - want) <= 2e-2 * np.maximum(np.abs(want), 1e-2)
    assert close.mean() > 0.995


def test_spherical_limit():
    """For a spherical perturbation the collapse delta_c should be close to
    1.686 (the -0.364 correction term enforces this, Monaco 1996a)."""
    import jax.numpy as jnp
    from pinocchio_jax.ops.collapse import ell_classic
    delta = 1.0
    lam = jnp.float32(delta / 3.0)
    bc = float(ell_classic(lam, lam, lam))
    assert bc > 0
    assert abs(bc * delta - 1.686) / 1.686 < 0.03


def test_inverse_growth_roundtrip_device(hmf_validation_cosmology):
    import jax.numpy as jnp
    from pinocchio_jax.ops.collapse import (make_inverse_growth_table,
                                            uniform_lookup)
    c = hmf_validation_cosmology
    tab, (lo, dx) = make_inverse_growth_table(c)
    for z in (0.0, 1.0, 4.0, 20.0):
        D = float(c.GrowingMode(z))
        la = uniform_lookup(tab, lo, dx,
                            jnp.log10(jnp.float32(D)))
        got = 10.0 ** (-float(la)) - 1.0
        assert abs(got - z) < 2e-3 * (1 + z)
