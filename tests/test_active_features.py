"""Tests for active-sampling features wired in round 2: the GP-train cost
model, repeated observations for noisy targets, integer variables, the
initial-design k-means thinning + search cache, and the coarse bucket
profile (accelerator shape planning)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vbmc_tpu import state as st


def _fake_stats(n_iter, gp_times, Ns, neffs):
    stats = st.Stats()
    for i in range(n_iter):
        stats.add(st.IterStats(
            iter=i + 1, elbo=0.0, elbo_sd=0.1, sKL=0.0, sKL_true=None,
            K=2, N=int(Ns[i]), neff=float(neffs[i]), func_count=int(neffs[i]),
            warmup=False, pruned=0, varss=0.0,
            timer={"active_sampling": 0.2, "gp_train": float(gp_times[i]),
                   "variational_fit": 0.3, "finalize": 0.1}))
    return stats


def test_cost_model_regression():
    """t_algoperfuneval = t_base/deltaNeff + marginal gp-train cost from a
    log-log fit (cf. `activesample_vbmc.m:185-204`)."""
    n = 8
    Ns = 10 + 5 * np.arange(n)
    neffs = Ns.astype(float)
    # gp_train time follows a power law t = c * N^2 exactly.
    c = 1e-4
    gp_times = c * Ns.astype(float) ** 2
    stats = _fake_stats(n, gp_times, Ns, neffs)
    state = st.OptimState()
    val = st.update_cost_model(state, stats)
    t_base = 0.2 + 0.3 + 0.1 + gp_times[-1]
    expected_diff = c * ((Ns[-1] + 1.0) ** 2 - Ns[-1] ** 2)
    expected = t_base / 5.0 + expected_diff
    assert val == pytest.approx(expected, rel=1e-6)
    assert state.t_algoperfuneval == val


def test_cost_model_early_iterations():
    stats = _fake_stats(2, [0.1, 0.1], [10, 15], [10.0, 15.0])
    state = st.OptimState()
    val = st.update_cost_model(state, stats)
    assert math.isfinite(val) and val > 0
    # No regression term before iteration 4.
    assert val == pytest.approx((0.2 + 0.3 + 0.1 + 0.1) / 5.0)


@pytest.mark.slow
def test_repeated_observations_merge():
    """With max_repeated_observations > 0 a noisy run re-measures existing
    points, exercising the precision-weighted duplicate merge
    (`activesample_vbmc.m:334-365`, `funlogger_vbmc.m:229-247`)."""
    from vbmc_tpu import vbmc, VBMCOptions

    sd = np.array([1.0, 0.6])
    rng = np.random.default_rng(3)

    def noisy(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + 3.0 * rng.standard_normal()), 3.0

    opts = VBMCOptions(display="off", max_fun_evals=30, seed=3,
                       specify_target_noise=True,
                       max_repeated_observations=3,
                       repeated_acq_discount=2.0,
                       min_final_components=4)
    res = vbmc(noisy, x0=np.array([0.5, 0.5]), lb=np.zeros(2),
               ub=np.full(2, 10.0), plb=np.full(2, 0.05),
               pub=np.full(2, 3.0), options=opts)
    lg = res.logger
    nevals = lg.nevals[:lg.Xn]
    # At least one point was re-measured and merged.
    assert np.any(nevals > 1)
    assert lg.neff > lg.n_train
    # Merged noise SD shrinks below the single-observation SD of 3.
    merged = np.where(nevals > 1)[0]
    assert np.all(lg.S[merged] < 3.0)

    # With the option off, no repeats occur (same seed/target).
    rng2 = np.random.default_rng(3)

    def noisy2(x):
        y = (-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
             - np.sum(np.log(sd)))
        return float(y + 3.0 * rng2.standard_normal()), 3.0

    opts_off = VBMCOptions(display="off", max_fun_evals=30, seed=3,
                           specify_target_noise=True,
                           min_final_components=4)
    res2 = vbmc(noisy2, x0=np.array([0.5, 0.5]), lb=np.zeros(2),
                ub=np.full(2, 10.0), plb=np.full(2, 0.05),
                pub=np.full(2, 3.0), options=opts_off)
    assert np.all(res2.logger.nevals[:res2.logger.Xn] <= 1)


def test_integer_vars_round_through_transform():
    """integer_vars rounds candidate coordinates in ORIGINAL space
    (`misc/real2int_vbmc.m`, call sites `activesample_vbmc.m:219,248`)."""
    from vbmc_tpu import vbmc, VBMCOptions

    evals = []

    def fun(x):
        evals.append(np.array(x, float))
        return float(-0.5 * np.sum(((x - np.array([3.0, 0.0])) / 2.0) ** 2))

    opts = VBMCOptions(display="off", max_fun_evals=20, seed=1,
                       integer_vars=(0,), min_final_components=4)
    res = vbmc(fun, x0=np.array([3.0, 0.2]), lb=np.array([0.0, -10.0]),
               ub=np.array([10.0, 10.0]), plb=np.array([1.0, -3.0]),
               pub=np.array([6.0, 3.0]), options=opts)
    X = np.stack(evals)
    n_start = 10  # initial design is not rounded (reference behavior)
    frac = np.abs(X[n_start:, 0] - np.round(X[n_start:, 0]))
    assert np.all(frac < 1e-6)
    # The continuous dimension is NOT rounded.
    assert np.any(np.abs(X[:, 1] - np.round(X[:, 1])) > 1e-3)
    assert res.func_count >= 20


def test_initial_design_kmeans_thinning():
    """An oversized starting cache is k-means-thinned keeping the best
    representative per cluster (`initdesign_vbmc.m:30-45`)."""
    from vbmc_tpu.active_sample import initial_design
    from vbmc_tpu.function_logger import FunctionLogger
    from vbmc_tpu.transforms import create_trinfo

    D = 2
    ti = create_trinfo([-10.0] * D, [10.0] * D, [-3.0] * D, [3.0] * D)
    calls = []

    def fun(x):
        calls.append(x)
        return float(-0.5 * np.sum(x ** 2))

    logger = FunctionLogger(fun, D, ti)
    rng = np.random.default_rng(0)
    cache = rng.uniform(-2, 2, (40, D))
    fvals = -0.5 * np.sum(cache ** 2, axis=1)
    leftover, leftover_y = initial_design(
        jax.random.PRNGKey(0), logger, 10, np.full(D, -3.0),
        np.full(D, 3.0), x0_cache=cache, fvals_cache=fvals)
    # All 10 points come from the cache (no target evaluations needed).
    assert logger.Xn == 10
    assert len(calls) == 0
    assert leftover.shape[0] == 30
    # Chosen points have the highest density within their clusters: their
    # mean objective beats the leftover mean.
    assert logger.y_orig[:10].mean() > leftover_y.mean()


def test_search_cache_frac_used():
    """search_cache_frac > 0 injects leftover cache points into the search
    set (`activesample_vbmc.m:545-558`)."""
    from vbmc_tpu.active_sample import get_search_points, SearchBounds
    from vbmc_tpu.function_logger import FunctionLogger
    from vbmc_tpu.transforms import create_trinfo
    from vbmc_tpu.vp import make_vp
    from vbmc_tpu.options import VBMCOptions

    D = 2
    ti = create_trinfo([-10.0] * D, [10.0] * D, [-3.0] * D, [3.0] * D)
    logger = FunctionLogger(lambda x: float(-np.sum(x ** 2)), D, ti)
    for i in range(6):
        logger.evaluate(np.array([0.1 * i, -0.1 * i]))
    vp = make_vp(ti, np.zeros((2, D)), 0.5, np.ones(D), k_max=4)
    sb = SearchBounds.init(np.full(D, -3.0), np.full(D, 3.0),
                           np.full(D, -10.0), np.full(D, 10.0), 2.0)
    opt = VBMCOptions(search_cache_frac=0.25).resolve(D)
    cache = np.tile(np.array([[1.234, -0.567]]), (50, 1))
    Xs = get_search_points(jax.random.PRNGKey(1), 64, vp, logger, sb, opt,
                           search_cache=cache)
    n_cached = int(np.sum(np.all(np.abs(Xs - cache[0]) < 1e-9, axis=1)))
    assert n_cached == 16


def test_coarse_bucket_profile():
    from vbmc_tpu.utils.math import (bucket_n, bucket_k, bucket_ns,
                                     set_bucket_mode)
    set_bucket_mode("coarse")
    try:
        assert bucket_n(10) == 128 and bucket_n(129) == 256
        assert bucket_k(2) == 32 and bucket_k(33) == 64
        assert bucket_ns(1) == 16 and bucket_ns(17) == 80
    finally:
        set_bucket_mode("fine")


def test_coarse_padding_is_exact():
    """Coarse padding (N rows masked, S samples masked) must leave the GP
    likelihood and predictions numerically unchanged at FIXED
    hyperparameters — the masking is exact, not approximate."""
    from vbmc_tpu.gp.config import GPConfig, MEAN_NEGQUAD
    from vbmc_tpu.gp import core
    from vbmc_tpu.gp.gp import build_gp
    from vbmc_tpu.gp.predict import gp_predict
    from vbmc_tpu.utils.math import pad_to

    rng = np.random.default_rng(0)
    D = 2
    n = 20
    X = rng.uniform(-2, 2, (n, D))
    y = -0.5 * np.sum(X ** 2, axis=1) + 0.05 * rng.standard_normal(n)
    cfg = GPConfig(D=D, meanfun=MEAN_NEGQUAD, const_noise=1)
    hyp = np.concatenate([np.log([0.8, 1.1]), [0.3], np.log([0.05]),
                          [y.max(), 0.0, 0.0, 0.0, 0.0]])[:cfg.nhyp]
    Xs = jnp.asarray(rng.uniform(-2, 2, (8, D)))

    def padded(nb, sb):
        Xp = jnp.asarray(pad_to(X, nb))
        yp = jnp.asarray(pad_to(y, nb))
        s2p = jnp.zeros(nb)
        mask = jnp.asarray(np.arange(nb) < n)
        nll = core.neg_log_marginal_likelihood(cfg, jnp.asarray(hyp), Xp,
                                               yp, s2p, mask)
        hyps = jnp.asarray(np.tile(hyp[None, :], (sb, 1)))
        hyp_mask = jnp.asarray(np.arange(sb) < 1)
        gp = build_gp(cfg, Xp, yp, s2p, mask, hyps, hyp_mask)
        f, v, _, _ = gp_predict(cfg, gp, Xs)
        return float(nll), np.asarray(f), np.asarray(v)

    nll_32, f_32, v_32 = padded(32, 1)       # fine-profile shapes
    nll_128, f_128, v_128 = padded(128, 16)  # coarse-profile shapes
    assert nll_128 == pytest.approx(nll_32, rel=1e-10)
    np.testing.assert_allclose(f_128, f_32, rtol=1e-10)
    np.testing.assert_allclose(v_128, v_32, rtol=1e-10)


def test_function_logger_rejects_nonscalar_returns():
    """A non-scalar target return must raise, not be silently truncated to
    its first element (`funlogger_vbmc.m:87-89`) — a (fval, sd) pair here
    means the user forgot specify_target_noise=True."""
    from vbmc_tpu.function_logger import FunctionLogger
    from vbmc_tpu.transforms import create_trinfo

    D = 2
    ti = create_trinfo([-10.0] * D, [10.0] * D, [-3.0] * D, [3.0] * D)
    logger = FunctionLogger(lambda x: np.zeros(2), D, ti)
    with pytest.raises(ValueError, match="non-scalar"):
        logger.evaluate(np.zeros(D))
    # Scalar-like returns (0-d arrays, length-1 arrays, python floats) pass.
    for fun in (lambda x: np.float64(-1.0), lambda x: np.array(-1.0),
                lambda x: np.array([-1.0]), lambda x: -1.0):
        logger2 = FunctionLogger(fun, D, ti)
        y, _ = logger2.evaluate(np.zeros(D))
        assert np.isfinite(y)
    # The noisy (fval, sd) tuple path is unaffected.
    logger3 = FunctionLogger(lambda x: (-1.0, 0.5), D, ti,
                             uncertainty_level=2)
    y, _ = logger3.evaluate(np.zeros(D))
    assert np.isfinite(y)


def test_function_logger_noisy_requires_pair():
    """specify_target_noise=True with a scalar-returning target raises a
    clear ValueError, not a TypeError from tuple indexing."""
    from vbmc_tpu.function_logger import FunctionLogger
    from vbmc_tpu.transforms import create_trinfo

    D = 2
    ti = create_trinfo([-10.0] * D, [10.0] * D, [-3.0] * D, [3.0] * D)
    logger = FunctionLogger(lambda x: -1.0, D, ti, uncertainty_level=2)
    with pytest.raises(ValueError, match="must return"):
        logger.evaluate(np.zeros(D))
