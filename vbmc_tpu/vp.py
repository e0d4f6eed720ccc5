"""Variational posterior: a mixture of K axis-rescaled Gaussians, stored as
padded masked arrays, plus the public posterior-query API
(cf. `vbmc_rnd.m`, `vbmc_pdf.m`, `vbmc_moments.m`, `vbmc_mode.m`,
`vbmc_kldiv.m`, `vbmc_mtv.m`, `vbmc_power.m`).

In transformed (unconstrained) space the density is

    q(x) = sum_k w_k N(x; mu_k, sigma_k^2 * diag(lambda^2))

Components beyond the active count K have w=0 and are excluded from every
quantity via the component mask, so all shapes stay static under jit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.transforms import (
    Trinfo, direct, inverse, log_abs_det_jacobian,
)
from vbmc_tpu.utils.math import mvn_kl

_LOG2PI = 1.8378770664093453


class VariationalPosterior(NamedTuple):
    w: jnp.ndarray        # (K_max,) mixture weights; 0 on padded slots
    eta: jnp.ndarray      # (K_max,) unnormalized log weights
    mu: jnp.ndarray       # (K_max, D) component means (transformed space)
    sigma: jnp.ndarray    # (K_max,) per-component scale
    lam: jnp.ndarray      # (D,) common axis scales (||lam||^2 = D)
    kmask: jnp.ndarray    # (K_max,) bool: active components
    trinfo: Trinfo

    @property
    def k_max(self) -> int:
        return self.w.shape[0]

    @property
    def D(self) -> int:
        return self.mu.shape[1]

    def n_active(self):
        return jnp.sum(self.kmask)


def make_vp(trinfo: Trinfo, mu: np.ndarray, sigma, lam, w=None,
            k_max: Optional[int] = None) -> VariationalPosterior:
    """Host-side constructor; pads K to ``k_max``."""
    mu = np.atleast_2d(np.asarray(mu, float))
    K, D = mu.shape
    if k_max is None:
        k_max = K
    dtype = jnp.zeros(0).dtype
    sigma = np.broadcast_to(np.asarray(sigma, float).ravel(), (K,))
    lam = np.asarray(lam, float).ravel()
    if w is None:
        w = np.full(K, 1.0 / K)
    w = np.asarray(w, float).ravel()
    w = w / w.sum()

    mu_p = np.zeros((k_max, D)); mu_p[:K] = mu
    sg_p = np.ones(k_max); sg_p[:K] = sigma
    w_p = np.zeros(k_max); w_p[:K] = w
    eta_p = np.full(k_max, -40.0)
    eta_p[:K] = np.log(np.maximum(w, 1e-30))
    kmask = np.arange(k_max) < K
    from vbmc_tpu.utils.hostcache import device_put_cached as _dpc
    return VariationalPosterior(
        w=_dpc(w_p, dtype=dtype), eta=_dpc(eta_p, dtype=dtype),
        mu=_dpc(mu_p, dtype=dtype), sigma=_dpc(sg_p, dtype=dtype),
        lam=_dpc(lam, dtype=dtype), kmask=_dpc(kmask),
        trinfo=trinfo)


def masked_softmax(eta: jnp.ndarray, kmask: jnp.ndarray) -> jnp.ndarray:
    neg = jnp.finfo(eta.dtype).min
    e = jnp.where(kmask, eta, neg)
    e = e - jnp.max(e)
    ex = jnp.exp(e) * kmask.astype(eta.dtype)
    return ex / jnp.sum(ex)


def vp_log_pdf_trans(vp: VariationalPosterior, X: jnp.ndarray,
                     df: float = 0.0) -> jnp.ndarray:
    """Log mixture density at transformed-space points X (M, D).

    df > 0 gives the heavy-tailed multivariate-t variant used for search-set
    generation (`vbmc_pdf.m:52-104`).
    """
    M = X.shape[0]
    D = vp.D
    scale = vp.sigma[:, None] * vp.lam[None, :]            # (K, D)
    z2 = jnp.sum(((X[None, :, :] - vp.mu[:, None, :])
                  / scale[:, None, :]) ** 2, axis=-1)      # (K, M)
    log_norm = -jnp.sum(jnp.log(scale), axis=-1)           # (K,)
    if df and df > 0:
        from jax.scipy.special import gammaln
        lognf = (gammaln(0.5 * (df + D)) - gammaln(0.5 * df)
                 - 0.5 * D * jnp.log(df * jnp.pi))
        comp = (lognf + log_norm[:, None]
                - 0.5 * (df + D) * jnp.log1p(z2 / df))
    else:
        comp = -0.5 * D * _LOG2PI + log_norm[:, None] - 0.5 * z2
    logw = jnp.where(vp.kmask, jnp.log(jnp.maximum(vp.w, jnp.finfo(vp.mu.dtype).tiny)),
                     -jnp.inf)
    return jax.scipy.special.logsumexp(comp + logw[:, None], axis=0)


def vp_pdf(vp: VariationalPosterior, X, orig_flag: bool = True,
           log_flag: bool = False, df: float = 0.0):
    """Density at points X; if ``orig_flag``, X is in original space and the
    Jacobian correction is applied (`vbmc_pdf.m:113-124`)."""
    X = jnp.atleast_2d(X)
    if orig_flag:
        U = direct(vp.trinfo, X)
        lp = vp_log_pdf_trans(vp, U, df=df) - log_abs_det_jacobian(vp.trinfo, U)
    else:
        lp = vp_log_pdf_trans(vp, X, df=df)
    return lp if log_flag else jnp.exp(lp)


def vp_rnd(vp: VariationalPosterior, key, N: int, orig_flag: bool = True,
           balance_flag: bool = False, df: float = 0.0,
           permute: bool = True) -> jnp.ndarray:
    """Draw N samples (`vbmc_rnd.m`). Balanced mode assigns samples to
    components proportionally (lower variance for moment estimates).

    ``permute=False`` skips the random shuffle of the balanced assignment:
    order-invariant consumers (moments, fESS weights, candidate sets) don't
    need it, and it lowers to a 1e5-element sort (compile time plus
    per-call sort time)."""
    k_cat, k_eps, k_chi, k_perm = jax.random.split(key, 4)
    logw = jnp.where(vp.kmask, jnp.log(jnp.maximum(vp.w, jnp.finfo(vp.mu.dtype).tiny)), -jnp.inf)
    if balance_flag:
        # Proportional allocation with randomized remainder, via sorted
        # repeated index trick (static shapes).
        counts = jnp.floor(vp.w * N).astype(jnp.int32)
        total = jnp.sum(counts)
        # Distribute the remainder by categorical draws.
        extra = jax.random.categorical(k_cat, logw, shape=(N,))
        base = jnp.repeat(jnp.arange(vp.k_max), counts, total_repeat_length=N)
        idx = jnp.where(jnp.arange(N) < total, base, extra)
        if permute:
            idx = jax.random.permutation(k_perm, idx)
    else:
        idx = jax.random.categorical(k_cat, logw, shape=(N,))
    eps = jax.random.normal(k_eps, (N, vp.D), dtype=vp.mu.dtype)
    if df and df > 0:
        chi2 = jax.random.gamma(k_chi, df / 2.0, (N, 1),
                                dtype=vp.mu.dtype) * 2.0
        eps = eps * jnp.sqrt(df / chi2)
    X = vp.mu[idx] + vp.sigma[idx][:, None] * vp.lam[None, :] * eps
    if orig_flag:
        X = inverse(vp.trinfo, X)
    return X


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("n_samples",))
def _moments_mc_jit(vp, key, n_samples: int):
    X = vp_rnd(vp, key, n_samples, orig_flag=True, balance_flag=True,
               permute=False)
    mean = jnp.mean(X, axis=0)
    Xc = X - mean
    cov = (Xc.T @ Xc) / (X.shape[0] - 1)
    return mean, cov


def vp_moments(vp: VariationalPosterior, orig_flag: bool = True,
               n_samples: int = 10 ** 6, key=None):
    """Mean and covariance (`vbmc_moments.m`): analytic in transformed space,
    Monte-Carlo through the inverse transform in original space."""
    if not orig_flag:
        w = vp.w
        mean = jnp.sum(w[:, None] * vp.mu, axis=0)
        dmu = vp.mu - mean
        cov = (dmu * w[:, None]).T @ dmu
        cov = cov + jnp.diag(jnp.sum(w * vp.sigma ** 2) * vp.lam ** 2)
        return mean, cov
    if key is None:
        key = jax.random.PRNGKey(0)
    return _moments_mc_jit(vp, key, n_samples)


def vp_mode(vp: VariationalPosterior, orig_flag: bool = True, key=None):
    """Posterior mode via multi-start optimization from component means
    (`vbmc_mode.m`)."""
    from vbmc_tpu.optim import minimize_lbfgs_bounded

    def nlp_trans(x):
        return -vp_log_pdf_trans(vp, x[None, :])[0]

    def nlp_orig_in_trans(x):
        # Optimize original-space density but parameterized in transformed
        # coords (unbounded): log q_orig(inv(x)) = logq_trans(x) - logjac.
        return -(vp_log_pdf_trans(vp, x[None, :])[0]
                 - log_abs_det_jacobian(vp.trinfo, x[None, :])[0])

    f = nlp_orig_in_trans if orig_flag else nlp_trans
    lb = jnp.full(vp.D, -jnp.inf, dtype=vp.mu.dtype)
    ub = jnp.full(vp.D, jnp.inf, dtype=vp.mu.dtype)

    def run(x0):
        return minimize_lbfgs_bounded(f, x0, lb, ub, maxiter=60)

    xs, fs = jax.vmap(run)(vp.mu)
    fs = jnp.where(vp.kmask, fs, jnp.inf)
    best = jnp.argmin(fs)
    x_best = xs[best]
    return inverse(vp.trinfo, x_best[None, :])[0] if orig_flag else x_best


@_partial(jax.jit, static_argnames=("n_samples", "gauss_flag"))
def _kldiv_jit(vp1, vp2, key, n_samples: int, gauss_flag: bool):
    k1, k2 = jax.random.split(key)
    if gauss_flag:
        # Gaussianized KL via moments (default in the iteration loop).
        m1, c1 = _moments_mc_jit(vp1, k1, n_samples)
        m2, c2 = _moments_mc_jit(vp2, k2, n_samples)
        kl1, kl2 = mvn_kl(m1, c1, m2, c2)
        return jnp.stack([kl1, kl2])
    X1 = vp_rnd(vp1, k1, n_samples, orig_flag=False)
    X2 = vp_rnd(vp2, k2, n_samples, orig_flag=False)
    lp11 = vp_log_pdf_trans(vp1, X1)
    lp21 = vp_log_pdf_trans(vp2, X1)
    lp22 = vp_log_pdf_trans(vp2, X2)
    lp12 = vp_log_pdf_trans(vp1, X2)
    kl1 = jnp.maximum(jnp.mean(lp11 - lp21), 0.0)
    kl2 = jnp.maximum(jnp.mean(lp22 - lp12), 0.0)
    return jnp.stack([kl1, kl2])


def vp_kldiv(vp1: VariationalPosterior, vp2: VariationalPosterior,
             n_samples: int = 10 ** 5, gauss_flag: bool = True, key=None):
    """Symmetrized KL components (KL(1||2), KL(2||1)) — `vbmc_kldiv.m`.
    One device program (lazy result; callers may batch the pull)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    return _kldiv_jit(vp1, vp2, key, n_samples, bool(gauss_flag))


def vp_mtv(vp1: VariationalPosterior, vp2: VariationalPosterior,
           n_samples: int = 10 ** 5, key=None) -> jnp.ndarray:
    """Marginal total variation per dimension (`vbmc_mtv.m`): 1-D KDEs on a
    2^13-point mesh, trapezoidal integration of |p1 - p2| / 2."""
    from vbmc_tpu.utils.kde import kde1d

    if key is None:
        key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    X1 = np.asarray(vp_rnd(vp1, k1, n_samples, orig_flag=True))
    X2 = np.asarray(vp_rnd(vp2, k2, n_samples, orig_flag=True))
    D = X1.shape[1]
    mtv = np.zeros(D)
    nkde = 2 ** 13
    for d in range(D):
        lo1, hi1 = X1[:, d].min(), X1[:, d].max()
        lo2, hi2 = X2[:, d].min(), X2[:, d].max()
        lo = min(lo1, lo2) - 0.1 * (max(hi1, hi2) - min(lo1, lo2))
        hi = max(hi1, hi2) + 0.1 * (max(hi1, hi2) - min(lo1, lo2))
        f1, grid = kde1d(X1[:, d], nkde, lo, hi)
        f2, _ = kde1d(X2[:, d], nkde, lo, hi)
        f1 = f1 / np.trapezoid(f1, grid)
        f2 = f2 / np.trapezoid(f2, grid)
        mtv[d] = 0.5 * np.trapezoid(np.abs(f1 - f2), grid)
    return jnp.asarray(mtv)


def vp_train2real(vp: VariationalPosterior, temperature: int,
                  elbo: float, elbo_sd: float):
    """Convert a tempered training posterior to the real posterior
    (cf. `misc/vptrain2real.m`): vp_real = vp^T with
    elbo_real = T*elbo + lnZ_pow."""
    if temperature is None or temperature == 1:
        return vp, elbo, elbo_sd
    vp_real, lnz_pow = vp_power(vp, n=temperature, return_lnz=True)
    return vp_real, temperature * elbo + lnz_pow, temperature * elbo_sd


def vp_power(vp: VariationalPosterior, n: int = 2,
             cutoff: float = 1e-6, return_lnz: bool = False):
    """Power posterior vp^n for tempering, n=2 (`vbmc_power.m`): the square
    of a Gaussian mixture is a K^2-component mixture (up to normalization)."""
    if n == 1:
        return vp
    if n != 2:
        raise NotImplementedError("only n in {1, 2} supported")
    K = int(np.sum(np.asarray(vp.kmask)))
    w = np.asarray(vp.w)[:K]
    mu = np.asarray(vp.mu)[:K]
    sigma = np.asarray(vp.sigma)[:K]
    lam = np.asarray(vp.lam)
    D = lam.shape[0]

    # Product of components j,k: Gaussian with combined precision.
    s2 = sigma ** 2
    pairs_w = []
    pairs_mu = []
    pairs_sigma = []
    for j in range(K):
        for k in range(K):
            s2jk = s2[j] * s2[k] / (s2[j] + s2[k])
            mujk = (mu[j] * s2[k] + mu[k] * s2[j]) / (s2[j] + s2[k])
            # Overlap factor: N(mu_j; mu_k, (s2_j + s2_k) lam^2)
            d2 = np.sum(((mu[j] - mu[k]) / lam) ** 2) / (s2[j] + s2[k])
            logz = (-0.5 * D * np.log(2 * np.pi)
                    - 0.5 * D * np.log(s2[j] + s2[k])
                    - np.sum(np.log(lam)) - 0.5 * d2)
            pairs_w.append(w[j] * w[k] * np.exp(logz))
            pairs_mu.append(mujk)
            pairs_sigma.append(np.sqrt(s2jk))
    pw = np.asarray(pairs_w)
    lnz_pow = float(np.log(max(pw.sum(), 1e-300)))
    pw = pw / pw.sum()
    keep = pw > cutoff * pw.max()
    pw = pw[keep] / pw[keep].sum()
    pmu = np.asarray(pairs_mu)[keep]
    psigma = np.asarray(pairs_sigma)[keep]
    out = make_vp(vp.trinfo, pmu, psigma, lam, w=pw)
    if return_lnz:
        return out, lnz_pow
    return out


def is_valid_vp(obj) -> bool:
    """Duck-type check (`vbmc_isavp.m`)."""
    return isinstance(obj, VariationalPosterior)
