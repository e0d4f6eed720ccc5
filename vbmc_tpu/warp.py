"""Input warping (rotoscale reparameterization) and its propagation to the
GP hyperparameters and variational posterior
(cf. `misc/warp_input_vbmc.m`, `misc/warp_gpandvp_vbmc.m`,
`utils/unscent_warp.m`).

Runs entirely on the HOST in NumPy: the data is tiny (K x D, S x Nhyp) and
the eager-jnp version triggered hundreds of one-op XLA compiles per warp
plus thousands of latency-bound sequential dispatches.
The jitted device path never sees this module; it only receives the finished
trinfo/vp/hyp arrays.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax.numpy as jnp

from vbmc_tpu.transforms import (Trinfo, direct_np, inverse_np,
                                 log_abs_det_jacobian_np)
from vbmc_tpu.vp import VariationalPosterior
from vbmc_tpu.utils.hostcache import to_np, device_put_cached as _dpc


def unscent_warp(fun: Callable, x: np.ndarray, sigma: np.ndarray):
    """Coordinate-wise unscented transform of (mean, scale) through ``fun``.

    x: (N, D) locations; sigma: (N, D) per-coordinate scales.
    Returns (x_warped (N,D), sigma_warped (N,D)).
    """
    x = np.atleast_2d(np.asarray(x, float))
    sigma = np.broadcast_to(np.atleast_2d(np.asarray(sigma, float)), x.shape)
    N, D = x.shape
    U = 2 * D + 1
    xx = np.tile(x[None, :, :], (U, 1, 1))
    for d in range(D):
        s = np.sqrt(D) * sigma[:, d]
        xx[2 * d + 1, :, d] += s
        xx[2 * d + 2, :, d] -= s
    xu = np.asarray(fun(xx.reshape(U * N, D))).reshape(U, N, D)
    return xu.mean(axis=0), xu.std(axis=0, ddof=1)


def _vp_moments_np(vp: VariationalPosterior):
    """Analytic transformed-space moments of the VP, host math."""
    w = np.asarray(to_np(vp.w), float)
    mu = np.asarray(to_np(vp.mu), float)
    sigma = np.asarray(to_np(vp.sigma), float)
    lam = np.asarray(to_np(vp.lam), float)
    mean = np.sum(w[:, None] * mu, axis=0)
    dmu = mu - mean
    cov = (dmu * w[:, None]).T @ dmu
    cov = cov + np.diag(np.sum(w * sigma ** 2) * lam ** 2)
    return mean, cov


def compute_rotoscale(vp: VariationalPosterior, corr_thresh: float = 0.05,
                      cov_reg: float = 0.0) -> Trinfo:
    """Whitening transform from the variational covariance
    (`warp_input_vbmc.m:36-74`): SVD of the (correlation-masked) covariance
    in *base* transformed space; returns a new Trinfo with R_mat/scale set
    and recentered mu/delta cleared."""
    ti = vp.trinfo
    D = vp.D
    R_old = (np.asarray(to_np(ti.R_mat), float) if ti.R_mat is not None
             else np.eye(D))
    scale_old = (np.asarray(to_np(ti.scale), float) if ti.scale is not None
                 else np.ones(D))

    _, VV = _vp_moments_np(vp)
    # Covariance in the pre-rotoscale coordinate system.
    S = R_old @ (np.diag(scale_old) @ VV @ np.diag(scale_old)) @ R_old.T

    if corr_thresh > 0:
        d = np.sqrt(np.diag(S))
        corr = S / np.outer(d, d)
        S = np.where(np.abs(corr) > corr_thresh, S, 0.0)
    w_reg = float(np.clip(cov_reg, 0.0, 1.0))
    S = (1 - w_reg) * S + w_reg * np.diag(np.diag(S))

    U, sv, _ = np.linalg.svd(S)
    if np.linalg.det(U) < 0:
        U[:, 0] = -U[:, 0]
    scale = np.sqrt(sv + np.finfo(float).eps)

    dtype = ti.mu.dtype
    return ti._replace(R_mat=_dpc(U, dtype=dtype),
                       scale=_dpc(scale, dtype=dtype))


def update_plausible_bounds(trinfo: Trinfo, plb_orig, pub_orig, seed: int,
                            n_samples: int = 10 ** 5):
    """Quantile-based re-estimate of the transformed plausible box after a
    warp (`warp_input_vbmc.m:80-98`)."""
    D = plb_orig.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.random((n_samples, D))
    xx = plb_orig + u * (pub_orig - plb_orig)
    yy = direct_np(trinfo, xx)
    plb = np.quantile(yy, 0.05, axis=0)
    pub = np.quantile(yy, 0.95, axis=0)
    delta = pub - plb
    return plb - delta / 9.0, pub + delta / 9.0


def remap_search_box(trinfo_old: Trinfo, trinfo_new: Trinfo, lb_search,
                     ub_search, seed: int, n_samples: int = 1000):
    """Map the active-search box into the new space by sampling
    (`warp_input_vbmc.m:142-148`): draw uniformly in the old box, push the
    points through old-inverse -> new-direct, take the hull."""
    D = lb_search.shape[0]
    lo = np.where(np.isfinite(lb_search), lb_search, -10.0)
    hi = np.where(np.isfinite(ub_search), ub_search, 10.0)
    rng = np.random.default_rng(seed)
    u = rng.random((n_samples, D))
    xx = lo + u * (hi - lo)
    yy = direct_np(trinfo_new, inverse_np(trinfo_old, xx))
    yy = yy[np.all(np.isfinite(yy), axis=1)]
    if yy.shape[0] == 0:
        return lo.copy(), hi.copy()
    delta = yy.max(0) - yy.min(0)
    return yy.min(0) - delta / n_samples, yy.max(0) + delta / n_samples


def warp_gp_and_vp(trinfo_new: Trinfo, vp_old: VariationalPosterior,
                   gp_old, cfg, temperature: float = 1.0):
    """Map GP hyperparameters and VP parameters into the new space
    (`warp_gpandvp_vbmc.m`). Returns (vp_new, hyp_warped (S, Nhyp))."""
    trinfo_old = vp_old.trinfo
    D = vp_old.D
    T = temperature

    def warpfun(x):
        return direct_np(trinfo_new, inverse_np(trinfo_old, x))

    def logjac(ti, x):
        return log_abs_det_jacobian_np(ti, np.asarray(x, float))

    # --- GP hyperparameters -----------------------------------------
    hyp = np.asarray(to_np(gp_old.hyp), float).copy()    # (S, Nhyp)
    X_np = np.asarray(to_np(gp_old.X), float)
    mask = np.asarray(to_np(gp_old.mask), bool)
    X_act = X_np[mask]
    for s in range(hyp.shape[0]):
        ell = np.exp(hyp[s, :D])
        _, ell_new = unscent_warp(warpfun, X_act,
                                  np.tile(ell, (X_act.shape[0], 1)))
        hyp[s, :D] = np.mean(np.log(np.maximum(ell_new, 1e-12)), axis=0)
        i_m = cfg.ncov + cfg.nnoise
        if cfg.meanfun == 1:  # const
            dy_old = logjac(trinfo_old, X_act)
            dy = logjac(trinfo_new, warpfun(X_act))
            hyp[s, i_m] += (np.mean(dy) - np.mean(dy_old)) / T
        elif cfg.meanfun == 4:  # negquad
            xm = hyp[s, i_m + 1:i_m + 1 + D]
            omega = np.exp(hyp[s, i_m + 1 + D:i_m + 1 + 2 * D])
            xmw, omegaw = unscent_warp(warpfun, xm[None, :], omega[None, :])
            dy_old = logjac(trinfo_old, xm[None, :])[0]
            dy = logjac(trinfo_new, xmw)[0]
            hyp[s, i_m] += (dy - dy_old) / T
            hyp[s, i_m + 1:i_m + 1 + D] = xmw[0]
            hyp[s, i_m + 1 + D:i_m + 1 + 2 * D] = \
                np.log(np.maximum(omegaw[0], 1e-12))
    # --- variational posterior --------------------------------------
    kmask = np.asarray(to_np(vp_old.kmask), bool)
    mu = np.asarray(to_np(vp_old.mu), float)
    sigma = np.asarray(to_np(vp_old.sigma), float)
    lam = np.asarray(to_np(vp_old.lam), float)
    w = np.asarray(to_np(vp_old.w), float)

    sigmalambda = sigma[:, None] * lam[None, :]          # (K, D)
    muw, slw = unscent_warp(warpfun, mu, sigmalambda)
    slw = np.maximum(slw, 1e-12)
    lam_new = np.sqrt(D * np.mean(slw[kmask] ** 2
                                  / np.sum(slw[kmask] ** 2, axis=1,
                                           keepdims=True), axis=0))
    sigma_new = np.exp(np.mean(np.log(slw / lam_new[None, :]), axis=1))

    dy_old = logjac(trinfo_old, mu)
    dy = logjac(trinfo_new, muw)
    ww = w * np.exp(np.clip((dy - dy_old) / T, -100, 100))
    ww = np.where(kmask, ww, 0.0)
    ww = ww / max(ww.sum(), 1e-30)

    dtype = vp_old.mu.dtype
    vp_new = vp_old._replace(
        trinfo=trinfo_new,
        mu=_dpc(muw, dtype=dtype),
        sigma=_dpc(np.where(kmask, sigma_new, 1.0), dtype=dtype),
        lam=_dpc(lam_new, dtype=dtype),
        w=_dpc(ww, dtype=dtype),
        eta=_dpc(np.where(kmask, np.log(np.maximum(ww, 1e-30)),
                          -40.0), dtype=dtype))
    return vp_new, hyp
