"""Bounded coordinate-wise slice sampling, jit/vmap-native.

A re-design of `gplite/private/slicesamplebnd.m`: the sequential
stepping-out/shrinkage logic becomes `lax.while_loop`s inside a
`lax.fori_loop` over coordinates and steps; multiple chains run as a `vmap`
axis so hyperparameter ensembles are sampled in parallel instead of one long
thinned chain.

The target ``logpdf`` must be a pure JAX function of the sample vector; it is
evaluated under vmap across chains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_MAX_STEPOUT = 16
_MAX_SHRINK = 64


def _slice_coord(key, logpdf, x, d, logp_x, width, lb, ub):
    """One slice-sampling update of coordinate ``d``."""
    ku, kpos, kstep = jax.random.split(key, 3)
    dtype = x.dtype

    log_u = logp_x + jnp.log(jax.random.uniform(ku, dtype=dtype))

    # Random initial bracket of size `width` around x_d, clipped to bounds.
    r = jax.random.uniform(kpos, dtype=dtype)
    left = jnp.maximum(x[d] - r * width, lb[d])
    right = jnp.minimum(x[d] + (1.0 - r) * width, ub[d])

    def logp_at(v):
        return logpdf(x.at[d].set(v))

    # Stepping out (bounded).
    def out_cond(c):
        i, left, right, go_l, go_r = c
        return (i < _MAX_STEPOUT) & (go_l | go_r)

    def out_body(c):
        i, left, right, go_l, go_r = c
        new_left = jnp.maximum(left - width, lb[d])
        new_right = jnp.minimum(right + width, ub[d])
        # Left/right bracket evaluations as ONE batched call: the N^3
        # Cholesky inside the GP logpdf runs as a (2,N,N) batch instead of
        # two sequential factorizations — halves the sequential depth of
        # the stepping-out phase (the hyp-sampling hot path).
        lp = jax.vmap(logp_at)(jnp.stack([left, right]))
        go_l = go_l & (lp[0] > log_u) & (left > lb[d])
        go_r = go_r & (lp[1] > log_u) & (right < ub[d])
        left = jnp.where(go_l, new_left, left)
        right = jnp.where(go_r, new_right, right)
        return i + 1, left, right, go_l, go_r

    _, left, right, _, _ = jax.lax.while_loop(
        out_cond, out_body,
        (0, left, right, jnp.asarray(True), jnp.asarray(True)))

    # Shrinkage.
    def shr_cond(c):
        i, key, left, right, xd, logp, accepted = c
        return (i < _MAX_SHRINK) & (~accepted)

    def shr_body(c):
        i, key, left, right, xd, logp, accepted = c
        key, k = jax.random.split(key)
        prop = left + (right - left) * jax.random.uniform(k, dtype=dtype)
        logp_prop = logp_at(prop)
        ok = logp_prop > log_u
        new_left = jnp.where(prop < x[d], prop, left)
        new_right = jnp.where(prop >= x[d], prop, right)
        left = jnp.where(ok, left, new_left)
        right = jnp.where(ok, right, new_right)
        xd = jnp.where(ok, prop, xd)
        logp = jnp.where(ok, logp_prop, logp)
        return i + 1, key, left, right, xd, logp, accepted | ok

    _, _, _, _, xd, logp_x, accepted = jax.lax.while_loop(
        shr_cond, shr_body,
        (0, kstep, left, right, x[d], log_u, jnp.asarray(False)))

    # If shrinkage failed (pathological target), stay put.
    xd = jnp.where(accepted, xd, x[d])
    x = x.at[d].set(xd)
    return x, logpdf(x)


def _slice_sweep(key, logpdf, x, logp_x, widths, lb, ub):
    """One full sweep over all coordinates."""
    D = x.shape[0]

    def body(d, carry):
        key, x, logp_x = carry
        key, k = jax.random.split(key)
        x, logp_x = _slice_coord(k, logpdf, x, d, logp_x, widths[d], lb, ub)
        return key, x, logp_x

    key, x, logp_x = jax.lax.fori_loop(0, D, body, (key, x, logp_x))
    return x, logp_x


def slice_sample_chain(key, logpdf, x0, widths, lb, ub, n_keep, burn, thin,
                       n_keep_max: int):
    """Run one chain; collect up to ``n_keep_max`` samples (mask: i < n_keep).

    ``n_keep``, ``burn``, ``thin`` may be traced (dynamic trip counts → no
    recompilation as schedules change). Not jitted here: callers jit the
    enclosing computation so the target closure does not force retraces.
    Returns (samples (n_keep_max, D), logps (n_keep_max,)).
    """
    D = x0.shape[0]
    dtype = x0.dtype
    buf = jnp.zeros((n_keep_max, D), dtype=dtype)
    logbuf = jnp.full((n_keep_max,), -jnp.inf, dtype=dtype)

    logp0 = logpdf(x0)
    total = burn + n_keep * thin

    def body(i, carry):
        key, x, logp_x, buf, logbuf = carry
        key, k = jax.random.split(key)
        x, logp_x = _slice_sweep(k, logpdf, x, logp_x, widths, lb, ub)
        keep = (i >= burn) & ((i - burn + 1) % thin == 0)
        idx = jnp.clip((i - burn + 1) // thin - 1, 0, n_keep_max - 1)
        buf = jnp.where(keep, buf.at[idx].set(x), buf)
        logbuf = jnp.where(keep, logbuf.at[idx].set(logp_x), logbuf)
        return key, x, logp_x, buf, logbuf

    _, x, _, buf, logbuf = jax.lax.fori_loop(
        0, total, body, (key, x0, logp0, buf, logbuf))
    return buf, logbuf


def slice_sample_ensemble(key, logpdf, x0s, widths, lb, ub, n_keep_per_chain,
                          burn, thin, n_keep_max_per_chain: int):
    """Run C chains in parallel (vmapped); returns stacked buffers.

    x0s: (C, D). Output: samples (C, n_keep_max_per_chain, D).
    """
    C = x0s.shape[0]
    keys = jax.random.split(key, C)

    def run(k, x0):
        return slice_sample_chain(k, logpdf, x0, widths, lb, ub,
                                  n_keep_per_chain, burn, thin,
                                  n_keep_max_per_chain)

    samples, logps = jax.vmap(run)(keys, x0s)
    return samples, logps
