"""Property tests for the transform layer: round-trip consistency and
log-Jacobians checked against autodiff (replacing the reference's hand-coded
checks in `shared/warpvars_vbmc_test.m`)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vbmc_tpu import transforms as tr


CASES = [
    # (lb, ub, plb, pub)
    ([-np.inf] * 3, [np.inf] * 3, [-2.0, -1.0, 0.0], [2.0, 3.0, 10.0]),
    ([0.0, -np.inf], [np.inf] * 2, [1.0, -5.0], [10.0, 5.0]),
    ([-np.inf, -np.inf], [0.0, 2.0], [-10.0, -3.0], [-1.0, 1.0]),
    ([0.0, -1.0], [1.0, 4.0], [0.1, 0.0], [0.9, 2.0]),
    ([-np.inf, 0.0, 0.0], [np.inf, np.inf, 1.0], [-1.0, 0.5, 0.2], [1.0, 2.0, 0.8]),
]


def _sample_inside(rng, lb, ub, plb, pub, n=50):
    lo = np.where(np.isfinite(lb), np.maximum(plb - 0.4 * (pub - plb), lb + 1e-6 * (np.where(np.isfinite(ub), ub - lb, 1.0))), plb - 2.0)
    hi = np.where(np.isfinite(ub), np.minimum(pub + 0.4 * (pub - plb), ub - 1e-6 * (np.where(np.isfinite(lb), ub - lb, 1.0))), pub + 2.0)
    return lo + (hi - lo) * rng.random((n, len(lb)))


@pytest.mark.parametrize("bounded_type", [tr.LOGIT, tr.PROBIT, tr.STUDENT4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_roundtrip(case, bounded_type, rng):
    lb, ub, plb, pub = (np.asarray(v, dtype=float) for v in CASES[case])
    ti = tr.create_trinfo(lb, ub, plb, pub, bounded_type=bounded_type)
    x = _sample_inside(rng, lb, ub, plb, pub)
    y = tr.direct(ti, jnp.asarray(x))
    x2 = tr.inverse(ti, y)
    np.testing.assert_allclose(np.asarray(x2), x, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("bounded_type", [tr.LOGIT, tr.PROBIT, tr.STUDENT4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_log_jacobian_vs_autodiff(case, bounded_type, rng):
    lb, ub, plb, pub = (np.asarray(v, dtype=float) for v in CASES[case])
    ti = tr.create_trinfo(lb, ub, plb, pub, bounded_type=bounded_type)
    x = _sample_inside(rng, lb, ub, plb, pub, n=12)
    y = np.asarray(tr.direct(ti, jnp.asarray(x)))

    lj = np.asarray(tr.log_abs_det_jacobian(ti, jnp.asarray(y)))
    for i in range(y.shape[0]):
        J = jax.jacfwd(lambda yy: tr.inverse(ti, yy))(jnp.asarray(y[i]))
        _, logdet = np.linalg.slogdet(np.asarray(J))
        np.testing.assert_allclose(lj[i], logdet, rtol=1e-6, atol=1e-6)


def test_rotoscale_roundtrip_and_jacobian(rng):
    lb = np.array([-np.inf, 0.0, -1.0])
    ub = np.array([np.inf, np.inf, 1.0])
    plb = np.array([-1.0, 0.5, -0.5])
    pub = np.array([1.0, 2.0, 0.5])
    ti = tr.create_trinfo(lb, ub, plb, pub)

    # Random rotation + scale.
    A = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(A)
    scale = np.array([0.5, 2.0, 1.3])
    ti = ti._replace(R_mat=jnp.asarray(Q), scale=jnp.asarray(scale))

    x = _sample_inside(rng, lb, ub, plb, pub, n=8)
    y = tr.direct(ti, jnp.asarray(x))
    x2 = tr.inverse(ti, y)
    np.testing.assert_allclose(np.asarray(x2), x, rtol=1e-8, atol=1e-8)

    lj = np.asarray(tr.log_abs_det_jacobian(ti, y))
    for i in range(x.shape[0]):
        J = jax.jacfwd(lambda yy: tr.inverse(ti, yy))(y[i])
        _, logdet = np.linalg.slogdet(np.asarray(J))
        np.testing.assert_allclose(lj[i], logdet, rtol=1e-6, atol=1e-6)


def test_probability_conservation(rng):
    """Transformed density with Jacobian correction integrates to ~1."""
    lb, ub = np.array([0.0]), np.array([1.0])
    ti = tr.create_trinfo(lb, ub, np.array([0.2]), np.array([0.8]))
    # Uniform(0,1) density in original space -> transformed density is the
    # Jacobian correction itself; numerically integrate over y.
    y = np.linspace(-40, 40, 20001)[:, None]
    logq = np.asarray(tr.log_abs_det_jacobian(ti, jnp.asarray(y)))
    integral = np.trapezoid(np.exp(logq), y[:, 0])
    np.testing.assert_allclose(integral, 1.0, rtol=1e-4)


def test_trinfo_pytree_structure_stable_under_warp(rng):
    """The first input warp must NOT change the trinfo pytree structure
    (R_mat/scale None -> array would recompile every jitted kernel taking
    a vp/trinfo and recompile every kernel)."""
    from vbmc_tpu.vp import make_vp
    from vbmc_tpu.warp import compute_rotoscale

    D = 3
    ti = tr.create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                          [2.0] * D)
    assert ti.R_mat is not None and ti.scale is not None
    vp = make_vp(ti, rng.standard_normal((4, D)), 0.5, np.ones(D), k_max=8)
    ti2 = compute_rotoscale(vp)
    assert (jax.tree_util.tree_structure(ti)
            == jax.tree_util.tree_structure(ti2))
    # identity rotoscale: the fresh trinfo must behave as if unrotated
    X = rng.standard_normal((10, D))
    np.testing.assert_allclose(np.asarray(tr.direct(ti, jnp.asarray(X))),
                               tr.direct_np(ti, X), rtol=1e-6)


def test_identity_rotoscale_preserves_infinities():
    """inf * 0 in the (identity) rotation matmul must not produce NaN:
    unbounded hard bounds map to +-inf and must survive the rotoscale
    stage (both jax and numpy twins)."""
    D = 3
    ti = tr.create_trinfo([-np.inf, 0.0, -np.inf], [np.inf, 10.0, np.inf],
                          [-2.0, 0.5, -2.0], [2.0, 3.0, 2.0])
    x = np.array([[-np.inf, 5.0, np.inf]])
    y_np = tr.direct_np(ti, x)
    y_jx = np.asarray(tr.direct(ti, jnp.asarray(x)))
    assert y_np[0, 0] == -np.inf and y_np[0, 2] == np.inf
    assert not np.any(np.isnan(y_np))
    np.testing.assert_allclose(y_jx[0, 1], y_np[0, 1], rtol=1e-6)
    assert y_jx[0, 0] == -np.inf and y_jx[0, 2] == np.inf
