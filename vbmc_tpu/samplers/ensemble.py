"""Ensemble slice sampling (cf. `utils/eissample_lite.m`): W = 2(D+1)
walkers; each walker updates by slice sampling along a direction defined by
two other walkers (differential directions, Karamanis & Beyer 2020 style).

Batched: the walker population advances as a batch; the per-walker slice
search is a `lax.while_loop`, the move over walkers a `lax.fori_loop`, and
the whole chain one jit-compiled `lax.scan`. Used for importance-sampling
MCMC refresh and as the 'covsample' GP-hyperparameter sampler.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

_MAX_SHRINK = 60


def _slice_direction(key, logpdf, x, logp_x, direction, lb, ub):
    """Slice sample along ``direction`` from x (scale folded in direction)."""
    ku, kb, ks = jax.random.split(key, 3)
    dtype = x.dtype
    log_u = logp_x + jnp.log(jax.random.uniform(ku, dtype=dtype))
    r = jax.random.uniform(kb, dtype=dtype)
    lo = -r
    hi = 1.0 - r

    def logp_at(t):
        prop = x + t * direction
        inside = jnp.all((prop >= lb) & (prop <= ub))
        lp = logpdf(prop)
        return jnp.where(inside & jnp.isfinite(lp), lp, -jnp.inf)

    def cond(c):
        i, key, lo, hi, t, lp, done = c
        return (i < _MAX_SHRINK) & (~done)

    def body(c):
        i, key, lo, hi, t, lp, done = c
        key, k = jax.random.split(key)
        prop_t = lo + (hi - lo) * jax.random.uniform(k, dtype=dtype)
        lp_p = logp_at(prop_t)
        ok = lp_p > log_u
        lo = jnp.where(ok | (prop_t >= 0), lo, prop_t)
        hi = jnp.where(ok | (prop_t < 0), hi, prop_t)
        t = jnp.where(ok, prop_t, t)
        lp = jnp.where(ok, lp_p, lp)
        return i + 1, key, lo, hi, t, lp, done | ok

    _, _, _, _, t, lp, done = jax.lax.while_loop(
        cond, body, (0, ks, lo, hi, jnp.asarray(0.0, dtype=dtype), log_u,
                     jnp.asarray(False)))
    x_new = jnp.where(done, x + t * direction, x)
    lp_new = jnp.where(done, lp, logp_x)
    return x_new, lp_new


def _slice_direction_batch(keys, logpdf, xs, lps, dirs, lb, ub):
    """Vmapped `_slice_direction`: all movers advance in LOCK-STEP, so each
    shrink iteration is ONE batched logpdf evaluation (for the GP target: a
    (H, N, N) Cholesky batch instead of H sequential
    factorizations)."""
    return jax.vmap(
        lambda k, x, lp, d: _slice_direction(k, logpdf, x, lp, d, lb, ub)
    )(keys, xs, lps, dirs)


def ensemble_slice_final(key, logpdf: Callable, x0s, lb, ub, n_steps,
                         mu_scale: float = 1.0):
    """Complementary-halves ensemble slice sampling, returning only the
    FINAL walker population (W, D) and its log-densities (W,).

    The batched 'covsample' (`get_GPTrainOptions.m:88-100`,
    `eissample_lite.m`) — and the reason it wins over coordinate-wise slice
    for GP hyperparameters: one sweep advances all W walkers with ~10
    batched target evaluations regardless of the dimension, while a
    coordinate sweep needs ~6 SEQUENTIAL evaluations per coordinate
    (~200 for the D=10 GP's 33 hyperparameters). Walkers split into two
    halves; each half moves along differential directions drawn from the
    other half (Karamanis & Beyer 2020 parallelization), so the batched
    moves remain a valid Markov kernel.

    ``n_steps`` may be a traced scalar (fori_loop trip count).
    """
    W, D = x0s.shape
    H = W // 2
    assert H >= 2, "ensemble needs at least 4 walkers"

    def half_move(k, movers, lps_m, others):
        k1, k2, k3 = jax.random.split(k, 3)
        n_oth = others.shape[0]
        i = jax.random.randint(k1, (H,), 0, n_oth)
        j = jax.random.randint(k2, (H,), 0, n_oth - 1)
        j = jnp.where(j >= i, j + 1, j)
        dirs = mu_scale * (others[i] - others[j])
        return _slice_direction_batch(jax.random.split(k3, H), logpdf,
                                      movers, lps_m, dirs, lb, ub)

    def sweep(s, carry):
        xs, lps = carry
        k = jax.random.fold_in(key, s)
        k1, k2 = jax.random.split(k)
        a, la = half_move(k1, xs[:H], lps[:H], xs[H:])
        xs = xs.at[:H].set(a)
        lps = lps.at[:H].set(la)
        b, lb_ = half_move(k2, xs[H:], lps[H:], xs[:H])
        xs = xs.at[H:].set(b)
        lps = lps.at[H:].set(lb_)
        return xs, lps

    lps0 = jax.vmap(logpdf)(x0s)
    xs, lps = jax.lax.fori_loop(0, n_steps, sweep, (x0s, lps0))
    return xs, lps


def ensemble_slice_sample(key, logpdf: Callable, x0s, lb, ub,
                          n_steps: int, mu_scale: float = 1.0):
    """Advance W walkers ``n_steps`` ensemble sweeps.

    x0s: (W, D) initial walkers. Returns (walkers (n_steps, W, D),
    logps (n_steps, W)) — thin/flatten at the caller.
    """
    W, D = x0s.shape

    def sweep(carry, k):
        xs, lps = carry

        def move_one(w, c):
            key, xs, lps = c
            key, k1, k2, k3 = jax.random.split(key, 4)
            # Differential direction from two distinct other walkers.
            i = jax.random.randint(k1, (), 0, W - 1)
            j = jax.random.randint(k2, (), 0, W - 2)
            i = jnp.where(i >= w, i + 1, i)
            j_adj = jnp.where(j >= jnp.minimum(i, w), j + 1, j)
            j_adj = jnp.where(j_adj >= jnp.maximum(i, w), j_adj + 1, j_adj)
            direction = mu_scale * (xs[i] - xs[j_adj])
            x_new, lp_new = _slice_direction(k3, logpdf, xs[w], lps[w],
                                             direction, lb, ub)
            xs = xs.at[w].set(x_new)
            lps = lps.at[w].set(lp_new)
            return key, xs, lps

        key2, xs, lps = jax.lax.fori_loop(0, W, move_one, (k, xs, lps))
        return (xs, lps), (xs, lps)

    lps0 = jax.vmap(logpdf)(x0s)
    keys = jax.random.split(key, n_steps)
    _, (walkers, logps) = jax.lax.scan(sweep, (x0s, lps0), keys)
    return walkers, logps
