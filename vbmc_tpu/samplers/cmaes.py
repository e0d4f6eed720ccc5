"""Batched CMA-ES for acquisition refinement (a batched replacement for the
reference's `utils/cmaes_modded.m`, used at `activesample_vbmc.m:265-290`).

Standard (mu/mu_w, lambda)-CMA-ES with rank-1 + rank-mu covariance updates;
each generation's population is evaluated as ONE batched call (the objective
is itself a jitted batch evaluator), and the generation loop is a
`lax.scan` with static length — no data-dependent Python control flow.
Bounds are handled by projection before evaluation.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CMAESResult(NamedTuple):
    x_best: jnp.ndarray
    f_best: jnp.ndarray
    x_mean: jnp.ndarray
    n_evals: int


def cmaes_minimize(key, f_batch: Callable, x0: jnp.ndarray,
                   sigma0: jnp.ndarray, lb: jnp.ndarray, ub: jnp.ndarray,
                   max_evals: int, popsize: int | None = None) -> CMAESResult:
    """Minimize f_batch((λ,D)->(λ,)) starting at x0 with per-dim scales
    sigma0. Runs ceil(max_evals/λ) generations."""
    D = x0.shape[0]
    dtype = x0.dtype
    if popsize is None:
        popsize = 4 + int(3 * math.log(max(D, 2)))
    lam = popsize
    mu = lam // 2
    w = jnp.log(mu + 0.5) - jnp.log(jnp.arange(1, mu + 1, dtype=dtype))
    w = w / jnp.sum(w)
    mueff = 1.0 / jnp.sum(w ** 2)

    cc = (4 + mueff / D) / (D + 4 + 2 * mueff / D)
    cs = (mueff + 2) / (D + mueff + 5)
    c1 = 2 / ((D + 1.3) ** 2 + mueff)
    cmu = jnp.minimum(1 - c1,
                      2 * (mueff - 2 + 1 / mueff) / ((D + 2) ** 2 + mueff))
    damps = 1 + 2 * jnp.maximum(0.0, jnp.sqrt((mueff - 1) / (D + 1)) - 1) + cs
    chiN = math.sqrt(D) * (1 - 1 / (4 * D) + 1 / (21 * D ** 2))

    # Active CMA (Jastrebski & Hansen 2006; the reference runs
    # `CMA.active=1`, `setupoptions_vbmc.m:176`): the worst-mu samples get
    # negative recombination weights, scaled to keep C positive definite.
    w_neg_raw = (jnp.log(mu + 0.5)
                 - jnp.log(jnp.arange(mu + 1, 2 * mu + 1, dtype=dtype)))
    w_neg_raw = w_neg_raw - jnp.max(w_neg_raw)          # all <= 0
    mueff_neg = (jnp.sum(w_neg_raw) ** 2
                 / jnp.maximum(jnp.sum(w_neg_raw ** 2), 1e-12))
    a_mu = 1.0 + c1 / jnp.maximum(cmu, 1e-12)
    a_mueff = 1.0 + 2.0 * mueff_neg / (mueff + 2.0)
    a_posdef = (1.0 - c1 - cmu) / (D * jnp.maximum(cmu, 1e-12))
    neg_scale = jnp.minimum(a_mu, jnp.minimum(a_mueff, a_posdef))
    w_neg = (w_neg_raw / jnp.maximum(-jnp.sum(w_neg_raw), 1e-12)) * neg_scale

    n_gen = max(int(math.ceil(max_evals / lam)), 1)

    # Normalize coordinates by sigma0 so C starts isotropic.
    scale = jnp.maximum(sigma0, 1e-12)

    def to_x(z):
        return jnp.clip(x0 + z * scale, lb, ub)

    class Carry(NamedTuple):
        key: jnp.ndarray
        m: jnp.ndarray       # mean in normalized coords
        sigma: jnp.ndarray
        C: jnp.ndarray
        ps: jnp.ndarray
        pc: jnp.ndarray
        x_best: jnp.ndarray
        f_best: jnp.ndarray

    def gen(carry: Carry, _):
        key, k1 = jax.random.split(carry.key)
        # Sample population.
        evals, B = jnp.linalg.eigh(carry.C)
        Dd = jnp.sqrt(jnp.maximum(evals, 1e-20))
        Z = jax.random.normal(k1, (lam, D), dtype=dtype)
        Y = (Z * Dd[None, :]) @ B.T                    # N(0, C)
        xs_norm = carry.m[None, :] + carry.sigma * Y
        xs = to_x(xs_norm)
        fs = f_batch(xs)
        fs = jnp.where(jnp.isfinite(fs), fs, jnp.finfo(dtype).max)

        order = jnp.argsort(fs)
        top = order[:mu]
        y_w = jnp.sum(w[:, None] * Y[top], axis=0)
        m_new = carry.m + carry.sigma * y_w

        # Step-size path.
        C_inv_sqrt_y = (B @ ((B.T @ y_w) / Dd))
        ps = (1 - cs) * carry.ps + \
            jnp.sqrt(cs * (2 - cs) * mueff) * C_inv_sqrt_y
        sigma_new = carry.sigma * jnp.exp(
            (cs / damps) * (jnp.linalg.norm(ps) / chiN - 1))
        sigma_new = jnp.clip(sigma_new, 1e-12, 1e6)

        # Covariance paths.
        hsig = (jnp.linalg.norm(ps)
                / jnp.sqrt(1 - (1 - cs) ** (2 * 1.0)) / chiN) < (1.4 + 2 / (D + 1))
        pc = (1 - cc) * carry.pc + \
            hsig * jnp.sqrt(cc * (2 - cc) * mueff) * y_w
        rank1 = jnp.outer(pc, pc)
        rank_mu = jnp.einsum("i,ij,ik->jk", w, Y[top], Y[top])
        # Active update: worst-mu directions, Mahalanobis-normalized so the
        # negative update cannot break positive definiteness.
        bot = order[lam - mu:]
        Y_bot = Y[bot]
        maha2 = jnp.sum(((Y_bot @ B) / Dd[None, :]) ** 2, axis=1)
        Y_hat = Y_bot * jnp.sqrt(D / jnp.maximum(maha2, 1e-12))[:, None]
        rank_neg = jnp.einsum("i,ij,ik->jk", -w_neg, Y_hat, Y_hat)
        C_new = ((1 - c1 - cmu) * carry.C + c1 * rank1
                 + cmu * (rank_mu - rank_neg))
        C_new = 0.5 * (C_new + C_new.T)

        f0 = fs[order[0]]
        better = f0 < carry.f_best
        x_best = jnp.where(better, xs[order[0]], carry.x_best)
        f_best = jnp.where(better, f0, carry.f_best)
        return Carry(key, m_new, sigma_new, C_new, ps, pc, x_best, f_best), None

    init = Carry(key=key, m=jnp.zeros(D, dtype=dtype),
                 sigma=jnp.asarray(1.0, dtype=dtype),
                 C=jnp.eye(D, dtype=dtype), ps=jnp.zeros(D, dtype=dtype),
                 pc=jnp.zeros(D, dtype=dtype), x_best=x0,
                 f_best=jnp.asarray(jnp.finfo(dtype).max, dtype=dtype))
    out, _ = jax.lax.scan(gen, init, None, length=n_gen)
    return CMAESResult(x_best=out.x_best, f_best=out.f_best,
                       x_mean=to_x(out.m), n_evals=n_gen * lam)
