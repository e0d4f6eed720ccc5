"""Inner optimizers: bounded L-BFGS and a tolerance-windowed Adam, both as
fixed-shape `lax.scan` loops (jit-friendly: no data-dependent Python control
flow; early convergence freezes the state instead of exiting).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax


def _to_unbounded(x, lb, ub):
    """Map x in (lb,ub) to an unconstrained z (scaled logit on finite dims)."""
    both = jnp.isfinite(lb) & jnp.isfinite(ub)
    span = jnp.where(both, ub - lb, 1.0)
    t = jnp.clip((x - lb) / span, 1e-12, 1 - 1e-12)
    z_logit = jnp.log(t) - jnp.log1p(-t)
    return jnp.where(both, z_logit, x)


def _to_bounded(z, lb, ub):
    both = jnp.isfinite(lb) & jnp.isfinite(ub)
    span = jnp.where(both, ub - lb, 1.0)
    x_logit = lb + span * jax.nn.sigmoid(z)
    return jnp.where(both, x_logit, z)


def minimize_lbfgs_bounded(f: Callable, x0, lb, ub, maxiter: int = 100):
    """Minimize f over box [lb, ub] via L-BFGS on a logit reparameterization.

    Returns (x_best, f_best). Differentiable objective required; NaN values
    are treated as +inf (step rejected by keeping the running best).
    """
    def g(z):
        return f(_to_bounded(z, lb, ub))

    z0 = _to_unbounded(jnp.clip(x0, lb, ub), lb, ub)
    opt = optax.lbfgs()
    state0 = opt.init(z0)
    f0 = g(z0)

    value_and_grad = optax.value_and_grad_from_state(g)

    def step(carry, _):
        z, state, zbest, fbest = carry
        value, grad = value_and_grad(z, state=state)
        updates, state = opt.update(grad, state, z, value=value, grad=grad,
                                    value_fn=g)
        z_new = optax.apply_updates(z, updates)
        bad = ~jnp.isfinite(value)
        improved = (~bad) & (value < fbest)
        zbest = jnp.where(improved, z, zbest)
        fbest = jnp.where(improved, value, fbest)
        z = jnp.where(jnp.isfinite(z_new).all(), z_new, z)
        return (z, state, zbest, fbest), value

    (z, _, zbest, fbest), _ = jax.lax.scan(
        step, (z0, state0, z0, f0), None, length=maxiter)
    # Final candidate may beat the running best.
    f_final = g(z)
    better = jnp.isfinite(f_final) & (f_final < fbest)
    zbest = jnp.where(better, z, zbest)
    fbest = jnp.where(better, f_final, fbest)
    return _to_bounded(zbest, lb, ub), fbest


class AdamResult(NamedTuple):
    x: jnp.ndarray          # averaged final iterate (batch-averaged)
    f: jnp.ndarray          # averaged recent objective
    x_trace: jnp.ndarray    # (maxiter, dim) iterates
    f_trace: jnp.ndarray    # (maxiter,) objective values
    n_iters: jnp.ndarray    # iteration at which convergence froze


def fminadam(f_value_and_grad: Callable, x0, lb=None, ub=None,
             tol_fun: float = 1e-3, maxiter: int = 1000,
             step_min: float = 0.001, step_max: float = 0.1,
             step_decay: float = 200.0, batch_size: int = 20,
             key=None):
    """Adam with the reference's decayed step schedule and slope-based
    stopping (cf. `utils/fminadam.m`): a `lax.while_loop` that EXITS at
    convergence (data-dependent trip count — no wasted device steps past
    the stopping test; under vmap, lanes freeze individually until the
    last lane converges).

    ``f_value_and_grad(x, key) -> (value, grad)`` (stochastic objectives take
    a PRNG key; pass key=None for deterministic objectives).
    """
    dim = x0.shape[0]
    dtype = x0.dtype
    if lb is None:
        lb = jnp.full(dim, -jnp.inf, dtype=dtype)
    if ub is None:
        ub = jnp.full(dim, jnp.inf, dtype=dtype)
    if key is None:
        key = jax.random.PRNGKey(0)

    beta1, beta2 = 0.9, 0.999
    eps = jnp.sqrt(jnp.finfo(dtype).eps)
    tol_x, tol_x_max = 0.001, 0.1
    tol_fun_max = tol_fun * 100.0
    min_iter = batch_size * 2

    # Slope regression design over one batch window.
    xxp = jnp.linspace(-(batch_size - 1) / 2.0, (batch_size - 1) / 2.0,
                       batch_size).astype(dtype)
    sxx = jnp.sum(xxp * xxp)

    def step(carry):
        it, x, m, v, xtab, ftab, frozen, n_frozen = carry
        key_i = jax.random.fold_in(key, it)
        value, grad = f_value_and_grad(x, key_i)
        m_new = beta1 * m + (1 - beta1) * grad
        v_new = beta2 * v + (1 - beta2) * grad * grad
        t = it + 1
        mhat = m_new / (1 - beta1 ** t)
        vhat = v_new / (1 - beta2 ** t)
        stepsize = step_min + (step_max - step_min) * jnp.exp(-t / step_decay)
        x_new = x - stepsize * mhat / (jnp.sqrt(vhat) + eps)
        x_new = jnp.clip(x_new, lb, ub)

        xtab = xtab.at[it].set(jnp.where(frozen, xtab[it], x_new))
        ftab = ftab.at[it].set(jnp.where(frozen, ftab[it], value))

        # Convergence check at batch boundaries.
        def check():
            fw = jax.lax.dynamic_slice(ftab, (it - batch_size + 1,),
                                       (batch_size,))
            slope = jnp.sum(xxp * (fw - jnp.mean(fw))) / sxx
            resid = fw - jnp.mean(fw) - slope * xxp
            se2 = jnp.sum(resid * resid) / jnp.maximum(batch_size - 2, 1) / sxx
            slope_err = jnp.sqrt(se2 + tol_fun ** 2)
            slope_err_max = jnp.sqrt(se2 + tol_fun_max ** 2)
            xw_now = jax.lax.dynamic_slice(
                xtab, (it - batch_size + 1, 0), (batch_size, dim))
            xw_prev = jax.lax.dynamic_slice(
                xtab, (it - 2 * batch_size + 1, 0), (batch_size, dim))
            dx = jnp.sqrt(jnp.sum(
                (jnp.mean(xw_now, 0) - jnp.mean(xw_prev, 0)) ** 2
            ) / batch_size)
            return ((dx < tol_x) & (jnp.abs(slope) < slope_err_max)) | \
                   ((jnp.abs(slope) < slope_err) & (dx < tol_x_max))

        is_batch_end = ((it + 1) % batch_size == 0) & (it + 1 >= min_iter)
        conv = jnp.where(is_batch_end, check(), False)
        newly_frozen = conv & (~frozen)
        n_frozen = jnp.where(newly_frozen, it + 1, n_frozen)
        frozen = frozen | conv

        x = jnp.where(frozen & ~newly_frozen, x, x_new)
        m = jnp.where(frozen & ~newly_frozen, m, m_new)
        v = jnp.where(frozen & ~newly_frozen, v, v_new)
        return (it + 1, x, m, v, xtab, ftab, frozen, n_frozen)

    def not_done(carry):
        it, _, _, _, _, _, frozen, _ = carry
        return (it < maxiter) & (~frozen)

    xtab0 = jnp.zeros((maxiter, dim), dtype=dtype)
    ftab0 = jnp.full((maxiter,), jnp.inf, dtype=dtype)
    init = (jnp.asarray(0), x0, jnp.zeros_like(x0), jnp.zeros_like(x0),
            xtab0, ftab0, jnp.asarray(False), jnp.asarray(maxiter))
    (_, x, _, _, xtab, ftab, _, n_frozen) = jax.lax.while_loop(
        not_done, step, init)

    # Average over the last filled batch window.
    last = jnp.minimum(n_frozen, maxiter)
    idx = jnp.arange(maxiter)
    in_window = (idx >= last - batch_size) & (idx < last)
    w = in_window.astype(dtype)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    x_avg = jnp.sum(xtab * w[:, None], axis=0)
    f_avg = jnp.sum(jnp.where(in_window, ftab, 0.0)) / jnp.maximum(jnp.sum(in_window), 1)
    return AdamResult(x=x_avg, f=f_avg, x_trace=xtab, f_trace=ftab,
                      n_iters=last)
