"""Batched complementary-halves ensemble slice sampler (the batched
'covsample', `get_GPTrainOptions.m:60-100`): distributional correctness on
an analytic target, and the D=10 GP-hyperparameter wiring
(`gp.fit.hyp_sampler_for` switches to the ensemble at nhyp > 24)."""

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.samplers.ensemble import ensemble_slice_final
from vbmc_tpu.gp import GPConfig, train_gp, TrainOptions, gp_predict
from vbmc_tpu.gp.fit import hyp_sampler_for


def test_ensemble_final_samples_gaussian(rng):
    # Correlated 2-D Gaussian: the pooled final walker populations over
    # many independent repetitions must reproduce mean/cov.
    cov = np.array([[1.0, 0.6], [0.6, 0.8]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def logp(x):
        return -0.5 * x @ prec @ x

    W, R = 16, 64
    lb = jnp.full(2, -10.0)
    ub = jnp.full(2, 10.0)

    def one(seed):
        k = jax.random.PRNGKey(seed)
        x0 = 0.1 * jax.random.normal(jax.random.fold_in(k, 1), (W, 2))
        xs, lps = ensemble_slice_final(k, logp, x0, lb, ub, 40)
        return xs

    pooled = np.concatenate([np.asarray(one(s)) for s in range(R)])
    assert pooled.shape == (W * R, 2)
    m = pooled.mean(0)
    c = np.cov(pooled.T)
    np.testing.assert_allclose(m, 0.0, atol=0.12)
    np.testing.assert_allclose(c, cov, atol=0.22)


def test_hyp_sampler_policy():
    assert hyp_sampler_for(GPConfig(D=2), 16) == "slice"    # nhyp = 9
    assert hyp_sampler_for(GPConfig(D=5), 16) == "slice"    # nhyp = 18
    assert hyp_sampler_for(GPConfig(D=6), 16) == "ensemble"  # nhyp = 21
    assert hyp_sampler_for(GPConfig(D=10), 16) == "ensemble"
    assert hyp_sampler_for(GPConfig(D=10), 4) == "slice"  # too few walkers


def test_train_gp_d10_uses_ensemble(rng):
    D, n = 10, 60
    cfg = GPConfig(D=D)
    assert cfg.nhyp > 24
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, 1)
    opts = TrainOptions(ns_samples=8, ninit=128, nopts=1, thin=2,
                       lbfgs_iters=30)
    gp, info = train_gp(jax.random.PRNGKey(0), cfg, X, y, None,
                        np.full(D, -2.0), np.full(D, 2.0), opts)
    hyp = np.asarray(jax.device_get(gp.hyp))
    mask = np.asarray(jax.device_get(gp.hyp_mask), bool)
    assert np.all(np.isfinite(hyp[mask]))
    # The ensemble must produce a dispersed (not collapsed) sample set.
    assert hyp[mask].std(axis=0).max() > 1e-4
    fbar, vtot, _, _ = gp_predict(cfg, gp, jnp.asarray(X[:8]))
    assert np.sqrt(np.mean((np.asarray(fbar) - y[:8]) ** 2)) < 0.5
