"""Masked GP core math: posterior factorization, marginal likelihood,
hyperpriors.

Design notes (vs `gplite/private/gplite_core.m`):

- All shapes are static: the training set lives in padded buffers of bucketed
  size N_max with a boolean mask, so the whole fit pipeline is jit-compiled
  once per bucket instead of recompiling as points accrue.  Masked-out rows
  are replaced by identity rows in the Gram matrix, contributing exactly zero
  to the likelihood and posterior.
- Gradients of the marginal likelihood come from autodiff through the
  Cholesky (replacing the 250-line hand-derived gradient in
  `gplite_core.m:200-274`).
- Batching over hyperparameter samples is a `vmap` axis; there is no loop
  over samples anywhere downstream.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular
from jax.scipy.special import gammaln

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.kernels import kernel_cross
from vbmc_tpu.gp.means import mean_function, int_mean_basis
from vbmc_tpu.gp.outwarp import (outwarp_direct, outwarp_deriv,
                                 outwarp_inverse)

from vbmc_tpu.gp.noise import noise_variance

_LOG2PI = 1.8378770664093453


class Posterior(NamedTuple):
    alpha: jnp.ndarray   # (N,)  B^{-1} (y - m), zero on padded rows
    L: jnp.ndarray       # (N,N) lower Cholesky of masked B = K + diag(sn2)
    Binv: jnp.ndarray    # (N,N) B^{-1} — hot paths become GEMMs
    sn2: jnp.ndarray     # (N,)  per-point noise variance
    chol_ok: jnp.ndarray  # () bool — Cholesky succeeded without escalation
    # Integrated-mean extras (None unless cfg.intmean > 0; cf. the
    # `intmean` posterior fields of `gplite_post.m:174-197`):
    betabar: jnp.ndarray = None   # (Nb,)   GLS estimate of basis coefficients
    HBinv: jnp.ndarray = None     # (Nb,N)  H B^{-1}
    Ainv: jnp.ndarray = None      # (Nb,Nb) (H B^{-1} H^T)^{-1}


def warped_observations(cfg: GPConfig, hyp: jnp.ndarray, y, s2, mask):
    """Apply the output warp to observations and user noise.

    Returns (t, s2_warped, log_jacobian) where log_jacobian is the summed
    masked log |dt/dy| (cf. `gplite_core.m:14-26,196-198`). Identity when
    the config has no warp.
    """
    if cfg.outwarp == 0:
        return y, s2, jnp.asarray(0.0, dtype=y.dtype)
    hyp_ow = hyp[cfg.sl_outwarp]
    t = outwarp_direct(cfg.outwarp, hyp_ow, y)
    g = outwarp_deriv(cfg.outwarp, hyp_ow, y)
    m = mask.astype(y.dtype)
    log_jac = jnp.sum(jnp.log(jnp.abs(g) + jnp.finfo(y.dtype).tiny) * m)
    s2w = None if s2 is None else s2 * g * g
    return t * m, s2w, log_jac


def gram_matrix(cfg: GPConfig, hyp: jnp.ndarray, X: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
    """Masked Gram matrix: identity rows/cols for padded entries."""
    K = kernel_cross(cfg, hyp, X, X)
    m = mask.astype(K.dtype)
    Mo = m[:, None] * m[None, :]
    return K * Mo


def _system_matrix(cfg: GPConfig, hyp: jnp.ndarray, X, y, s2, mask):
    """``y`` here is the ORIGINAL observation vector (the output-dependent
    noise feature keys on it even under an output warp, matching
    `gplite_core.m:35`); ``s2`` must already be warp-scaled by the caller."""
    K = gram_matrix(cfg, hyp, X, mask)
    m = mask.astype(K.dtype)
    sn2 = noise_variance(cfg, hyp[cfg.sl_noise], X, y=y, s2=s2)
    diag = sn2 * m + (1.0 - m)  # unit diagonal on padded rows
    B = K + jnp.diag(diag)
    return B, sn2


def robust_cholesky(B: jnp.ndarray):
    """Cholesky with jitter escalation (cf. `gplite_core.m:78-95`).

    Non-differentiable (uses `lax.while_loop`); for final posterior builds.
    Returns (L, ok_first_try).
    """
    n = B.shape[0]
    scale = jnp.mean(jnp.abs(jnp.diag(B)))
    eye = jnp.eye(n, dtype=B.dtype)

    def ok(L):
        return jnp.all(jnp.isfinite(jnp.diagonal(L)))

    L0 = jnp.linalg.cholesky(B)
    first_ok = ok(L0)

    def cond(c):
        t, L = c
        return (~ok(L)) & (t < 12)

    def body(c):
        t, _ = c
        jitter = scale * (10.0 ** (t - 12))  # starts at ~1e-12 * scale
        return t + 1, jnp.linalg.cholesky(B + jitter * eye)

    _, L = jax.lax.while_loop(cond, body, (jnp.array(1), L0))
    return L, first_ok


def build_posterior(cfg: GPConfig, hyp: jnp.ndarray, X, y, s2, mask,
                    robust: bool = True) -> Posterior:
    """Posterior factorization for one hyperparameter vector."""
    t, s2w, _ = warped_observations(cfg, hyp, y, s2, mask)
    B, sn2 = _system_matrix(cfg, hyp, X, y, s2w, mask)
    m = mask.astype(X.dtype)
    r = (t - mean_function(cfg, hyp[cfg.sl_mean], X)) * m
    if robust:
        L, ok = robust_cholesky(B)
    else:
        L = jnp.linalg.cholesky(B)
        ok = jnp.all(jnp.isfinite(jnp.diagonal(L)))
    alpha = cho_solve((L, True), r) * m
    # Explicit inverse: downstream quadratic forms (prediction variance,
    # quadrature covariance, IS precomputes) become batched matmuls
    # instead of triangular solves. The Cholesky (with jitter
    # escalation) keeps the factorization stable; the inverse is only used
    # inside clamped quadratic forms.
    eye = jnp.eye(B.shape[0], dtype=B.dtype)
    Binv = cho_solve((L, True), eye)
    betabar = HBinv = Ainv = None
    if cfg.nint > 0:
        # Integrated Bayesian-linear mean, vague coefficient prior: the GLS
        # coefficient estimate and its covariance factor (cf. the `intmean`
        # posterior block of `gplite_post.m` / `gplite_core.m:106-124`).
        H = int_mean_basis(cfg, X) * m[:, None]          # (N, Nb)
        BiH = cho_solve((L, True), H)                    # (N, Nb)
        A = H.T @ BiH                                    # (Nb, Nb)
        LA = jnp.linalg.cholesky(A)
        Ainv = cho_solve((LA, True), jnp.eye(cfg.nint, dtype=B.dtype))
        betabar = Ainv @ (H.T @ alpha)
        HBinv = BiH.T
    return Posterior(alpha=alpha, L=L, Binv=Binv, sn2=sn2, chol_ok=ok,
                     betabar=betabar, HBinv=HBinv, Ainv=Ainv)


def neg_log_marginal_likelihood(cfg: GPConfig, hyp: jnp.ndarray, X, y, s2,
                                mask) -> jnp.ndarray:
    """Masked negative log marginal likelihood (differentiable).

    Padded rows contribute 0: their residual is zero and their Cholesky
    diagonal is one. With an output warp the likelihood is over the warped
    observations plus the change-of-variables Jacobian
    (`gplite_core.m:196-198`); with an integrated mean the basis
    coefficients are marginalized exactly under a vague prior
    (`gplite_core.m:133-189`, vague-all branch).
    """
    t, s2w, log_jac = warped_observations(cfg, hyp, y, s2, mask)
    B, _ = _system_matrix(cfg, hyp, X, y, s2w, mask)
    m = mask.astype(X.dtype)
    r = (t - mean_function(cfg, hyp[cfg.sl_mean], X)) * m
    L = jnp.linalg.cholesky(B)
    a = cho_solve((L, True), r)
    n_real = jnp.sum(m)
    nlZ = (0.5 * jnp.dot(r, a)
           + jnp.sum(jnp.log(jnp.diagonal(L)) * m)
           + 0.5 * n_real * _LOG2PI)
    if cfg.nint > 0:
        # Vague-prior marginalization of the basis coefficients:
        # nlZ += -1/2 u^T A^{-1} u + 1/2 log|A| - Nb/2 log(2pi),
        # with A = H B^{-1} H^T and u = H B^{-1} r.
        H = int_mean_basis(cfg, X) * m[:, None]          # (N, Nb)
        BiH = cho_solve((L, True), H)
        A = H.T @ BiH
        u = H.T @ a
        LA = jnp.linalg.cholesky(A)
        w = solve_triangular(LA, u, lower=True)
        nlZ = (nlZ - 0.5 * jnp.dot(w, w)
               + jnp.sum(jnp.log(jnp.diagonal(LA)))
               - 0.5 * cfg.nint * _LOG2PI)
    return nlZ - log_jac


def hyperprior_logpdf(prior, hyp: jnp.ndarray) -> jnp.ndarray:
    """Log prior over hyperparameters (cf. `gplite/gplite_hypprior.m`).

    Per-hyperparameter: Student-t(df) if df in (0, inf), Gaussian if df <= 0
    or infinite, flat where sigma is non-finite. Bounds are enforced by the
    optimizer/sampler, not here.
    """
    mu, sigma, df = prior.mu, prior.sigma, prior.df
    has_prior = jnp.isfinite(sigma)
    sigma_s = jnp.where(has_prior, sigma, 1.0)
    z = (hyp - jnp.where(has_prior, mu, 0.0)) / sigma_s

    df_s = jnp.where((df > 0) & jnp.isfinite(df), df, 1.0)
    lp_t = (gammaln(0.5 * (df_s + 1.0)) - gammaln(0.5 * df_s)
            - 0.5 * jnp.log(jnp.pi * df_s) - jnp.log(sigma_s)
            - 0.5 * (df_s + 1.0) * jnp.log1p(z * z / df_s))
    lp_g = -0.5 * jnp.log(2.0 * jnp.pi) - jnp.log(sigma_s) - 0.5 * z * z

    use_t = (df > 0) & jnp.isfinite(df)
    lp = jnp.where(use_t, lp_t, lp_g)
    return jnp.sum(jnp.where(has_prior, lp, 0.0))


def gp_log_posterior(cfg: GPConfig, prior, hyp, X, y, s2, mask):
    """Unnormalized log posterior of hyperparameters (sampling target)."""
    return (-neg_log_marginal_likelihood(cfg, hyp, X, y, s2, mask)
            + hyperprior_logpdf(prior, hyp))


def solve_K(post: Posterior, v: jnp.ndarray) -> jnp.ndarray:
    """B^{-1} v given the posterior factorization."""
    return cho_solve((post.L, True), v)


def predict_one(cfg: GPConfig, hyp: jnp.ndarray, post: Posterior, X, y, mask,
                Xstar):
    """Latent mean/variance at Xstar for one hyperparameter sample.

    GEMM-shaped: k(X,X*) products against the stored B^{-1} instead of
    triangular solves. Returns (fmu (M,), fs2 (M,)).

    Integrated-mean correction per `gplite_pred.m:89-94,110-118`; output
    warp adjustment (inverse-warp the mean, delta-method variance) per
    `gplite_pred.m:130-149`.
    """
    m = mask.astype(X.dtype)
    ks = kernel_cross(cfg, hyp, X, Xstar) * m[:, None]     # (N, M)
    fmu = mean_function(cfg, hyp[cfg.sl_mean], Xstar) + ks.T @ post.alpha
    qf = jnp.sum(ks * (post.Binv @ ks), axis=0)            # (M,)
    kss = jnp.exp(2.0 * hyp[cfg.idx_log_sf])
    fs2 = jnp.maximum(kss - qf, 0.0)
    if cfg.nint > 0:
        hs = int_mean_basis(cfg, Xstar)                    # (M, Nb)
        R = hs - (post.HBinv @ ks).T                       # (M, Nb)
        fmu = fmu + R @ post.betabar
        fs2 = fs2 + jnp.sum(R * (R @ post.Ainv), axis=1)
    if cfg.outwarp != 0:
        hyp_ow = hyp[cfg.sl_outwarp]
        fmu = outwarp_inverse(cfg.outwarp, hyp_ow, fmu)
        g = outwarp_deriv(cfg.outwarp, hyp_ow, fmu)
        fs2 = fs2 / jnp.maximum(g * g, jnp.finfo(fs2.dtype).tiny)
    return fmu, fs2
