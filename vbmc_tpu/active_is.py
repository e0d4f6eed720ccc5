"""Importance-sampling machinery for information-based acquisitions
(VIQR / IMIQR, cf. `acq/acqviqr_vbmc.m`, `acq/acqimiqr_vbmc.m`,
`private/activeimportancesampling_vbmc.m`) and the kernel-integral
cross-covariance used by EIG (cf. `misc/intkernel.m`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.gp import GP
from vbmc_tpu.gp.kernels import kernel_cross
from vbmc_tpu.gp.predict import gp_predict_full
from vbmc_tpu.vp import VariationalPosterior, vp_rnd, vp_log_pdf_trans


@partial(jax.jit, static_argnames=("cfg",))
def int_kernel(cfg: GPConfig, gp: GP, vp: VariationalPosterior,
               Xs: jnp.ndarray) -> jnp.ndarray:
    """Posterior cross-covariance Cov(f(x_m), \\int q f) per hyp sample:
    E_q[k(x_m, .)] - k(x_m, X) B^{-1} E_q[k(X, .)]  (`intkernel.m:55-80`).

    Returns (S_max, M)."""
    from vbmc_tpu.elbo import _z_matrix
    z, _, _ = _z_matrix(cfg, gp, vp.mu, vp.sigma, vp.lam)   # (S, K, N)
    wk = vp.w * vp.kmask.astype(vp.w.dtype)
    zbar = jnp.einsum("k,skn->sn", wk, z)                   # (S, N)

    # E_q[k(x_m, .)] for candidate points: same closed form with X -> Xs.
    z_cand, _, _ = _z_matrix(cfg, gp._replace(X=Xs,
                                              mask=jnp.ones(Xs.shape[0],
                                                            dtype=bool)),
                             vp.mu, vp.sigma, vp.lam)       # (S, K, M)
    Ez = jnp.einsum("k,skm->sm", wk, z_cand)

    def corr(hyp, Binv, zb):
        ks = kernel_cross(cfg, hyp, gp.X, Xs) * gp.mask.astype(Xs.dtype)[:, None]
        return (Binv @ zb) @ ks                             # (M,)

    correction = jax.vmap(corr)(gp.hyp, gp.Binv, zbar)
    return Ez - correction


# ----------------------------------------------------------------------
# VIQR / IMIQR
# ----------------------------------------------------------------------

class ISState(NamedTuple):
    """Precomputed importance-sample set for VIQR/IMIQR.

    Xa: (Na, D) integration points; ln_weights: (S_max, Na) log importance
    weights (including the f-dependent part); invKzk: (S_max, N_max, Na)
    B^{-1} k(X, Xa) per hyp sample.
    """
    Xa: jnp.ndarray
    ln_weights: jnp.ndarray
    invKzk: jnp.ndarray
    f_s2: jnp.ndarray        # (S_max, Na) predictive variance at Xa


_U_IQR = 0.6744897501960817  # norminv(0.75)


def build_is_state(key, cfg: GPConfig, acq_name: str,
                   vp: VariationalPosterior, gp: GP, options) -> ISState:
    """Assemble the importance-sampling set (simplified batched version of
    `activeimportancesampling_vbmc.m`); thin host wrapper around the fully
    traceable `build_is_state_core`."""
    return build_is_state_core(
        key, cfg, acq_name, vp, gp,
        int(options.active_importance_sampling_vp_samples),
        int(options.active_importance_sampling_box_samples),
        int(options.active_importance_sampling_mcmc_samples),
        mh_steps=int(options.active_importance_sampling_mh_steps),
        fess_thresh=float(options.active_importance_sampling_fess_thresh))


def _mixture_draw(key, vp: VariationalPosterior, lo, hi, n_each: int,
                  n_box: int, dtype):
    """Draw one batch from the stratified IS proposal mixture: the smoothed
    variational posterior at 3 widening scales (`ais:116-126`) plus
    box-uniform draws around the training inputs (`ais:138-146`).
    Returns (X (Na, D), log_prop (Na,))."""
    D = vp.D
    k1, k2 = jax.random.split(key)
    parts = []
    scales = (1.0, np.sqrt(2.0), 2.0)
    for i, sc in enumerate(scales):
        vp_s = vp._replace(sigma=vp.sigma * sc)
        parts.append(vp_rnd(vp_s, jax.random.fold_in(k1, i), n_each,
                            orig_flag=False, balance_flag=True,
                            permute=False))
    u = jax.random.uniform(k2, (max(n_box, 1), D), dtype=dtype)
    parts.append(lo + u * (hi - lo))
    Xa = jnp.concatenate(parts, axis=0)
    Na = Xa.shape[0]

    # Exact proposal density of the stratified mixture (a misspecified
    # proposal would bias the self-normalized IS estimator): the 3 smoothed
    # vp components at their draw fractions + the box-uniform component.
    comps = [jnp.log(n_each / Na)
             + vp_log_pdf_trans(vp._replace(sigma=vp.sigma * sc), Xa)
             for sc in scales]
    log_box = -jnp.sum(jnp.log(hi - lo))
    in_box = jnp.all((Xa >= lo) & (Xa <= hi), axis=1)
    comps.append(jnp.where(in_box,
                           jnp.log(max(n_box, 1) / Na) + log_box, -jnp.inf))
    log_prop = jax.scipy.special.logsumexp(jnp.stack(comps, axis=0), axis=0)
    return Xa, log_prop


@partial(jax.jit, static_argnames=("cfg", "acq_name", "n_vp", "n_box",
                                   "n_mcmc", "mh_steps", "fess_thresh"))
def build_is_state_core(key, cfg: GPConfig, acq_name: str,
                        vp: VariationalPosterior, gp: GP, n_vp: int,
                        n_box: int, n_mcmc: int, mh_steps: int = 0,
                        fess_thresh: float = 0.9) -> ISState:
    """Importance-sample set as one device program: proposals from the
    smoothed variational posterior (3 widening scales) plus box-uniform
    draws around training inputs; weights from the current GP.

    fESS-gated MCMC refresh (`ais:37-104,153-235`), redesigned for batches:
    the reference advances walkers one at a time by ensemble slice sampling
    (`eissample_lite.m`) — a serial chain of single-point GP predictions.
    Here, when the fractional ESS of resampling the proposal set toward the
    IS *base* density (`acqviqr_vbmc.m:22-27` islogf: q(x)*2sinh(u*s(x)) for
    VIQR, exp(fmu)*2sinh(u*s) for IMIQR) falls below ``fess_thresh``, the
    set is importance-resampled to the base density and refined with
    ``mh_steps`` rounds of *independent* Metropolis-Hastings — each round
    one batched GP predict over all Na points. Same stationary density,
    device-shaped. IS weights then switch to log q - log base (exact for the
    refreshed set), giving bounded sinh-ratio weights at evaluation time.
    """
    D = vp.D
    dtype = gp.X.dtype

    k1, k2, k3 = jax.random.split(key, 3)
    # Box-uniform bounds around training points, masked device min/max so
    # the whole build stays inside one jit.
    m = gp.mask.astype(dtype)
    big = jnp.finfo(dtype).max
    Xmin = jnp.min(jnp.where(m[:, None] > 0, gp.X, big), axis=0)
    Xmax = jnp.max(jnp.where(m[:, None] > 0, gp.X, -big), axis=0)
    diam = Xmax - Xmin
    lo = Xmin - 0.5 * diam
    hi = Xmax + 0.5 * diam

    n_each = max((n_vp + n_mcmc) // 3, 1)
    Xa, log_prop = _mixture_draw(k1, vp, lo, hi, n_each, n_box, dtype)
    Na = Xa.shape[0]

    fmu, fs2 = gp_predict_full(cfg, gp, Xa)            # (S, Na)

    hm = gp.hyp_mask.astype(dtype)
    ns = jnp.maximum(jnp.sum(hm), 1.0)

    def _lnbase(X, fmu_x, fs2_x):
        """Log IS base density (hyp-averaged): q*2sinh(u*s) for VIQR,
        exp(fmu)*2sinh(u*s) for IMIQR (`acqviqr_vbmc.m:25-28`,
        `acqimiqr_vbmc.m:22-26`)."""
        s2bar = jnp.sum(fs2_x * hm[:, None], axis=0) / ns
        sbar = jnp.sqrt(jnp.maximum(s2bar, 1e-30))
        ln_sinh = jnp.log(2.0) + _log_sinh(_U_IQR * sbar)
        if acq_name == "viqr":
            return vp_log_pdf_trans(vp, X) + ln_sinh
        fbar = jnp.sum(fmu_x * hm[:, None], axis=0) / ns
        return fbar + ln_sinh

    if mh_steps > 0:
        lnbase = _lnbase(Xa, fmu, fs2)
        # Fractional ESS of retargeting the proposal set to the base
        # density (`fess_vbmc.m`; gate per `ais:60-64`).
        r = lnbase - log_prop
        r = jnp.where(jnp.isfinite(r), r, -jnp.inf)
        lr = r - jax.scipy.special.logsumexp(r)
        fess = 1.0 / jnp.sum(jnp.exp(2.0 * lr)) / Na
        need = fess < fess_thresh

        # Importance sampling-resampling toward the base density (ais:105).
        k_r, k_mh = jax.random.split(k3)
        idx = jax.random.categorical(k_r, r, shape=(Na,))
        idx = jnp.where(need, idx, jnp.arange(Na))
        Xa_c = Xa[idx]
        lnb_c = lnbase[idx]
        lp_c = log_prop[idx]
        fmu_c = fmu[:, idx]
        fs2_c = fs2[:, idx]

        # Independent-MH refinement: one batched proposal draw + one batched
        # GP predict per round (replaces the serial walker sweeps of
        # `eissample_lite.m`).
        def mh_round(carry, k):
            Xc, lnb, lp, fm, fv = carry
            ky, ka = jax.random.split(k)
            Y, lp_y = _mixture_draw(ky, vp, lo, hi, n_each, n_box, dtype)
            fmu_y, fs2_y = gp_predict_full(cfg, gp, Y)
            lnb_y = _lnbase(Y, fmu_y, fs2_y)
            ratio = (lnb_y - lp_y) - (lnb - lp)
            accept = (jnp.log(jax.random.uniform(ka, (Na,), dtype=dtype))
                      < ratio) & need
            Xc = jnp.where(accept[:, None], Y, Xc)
            lnb = jnp.where(accept, lnb_y, lnb)
            lp = jnp.where(accept, lp_y, lp)
            fm = jnp.where(accept[None, :], fmu_y, fm)
            fv = jnp.where(accept[None, :], fs2_y, fv)
            return (Xc, lnb, lp, fm, fv), None

        (Xa_c, lnb_c, lp_c, fmu_c, fs2_c), _ = jax.lax.scan(
            mh_round, (Xa_c, lnb_c, lp_c, fmu_c, fs2_c),
            jax.random.split(k_mh, mh_steps))

        # Refreshed set samples the base density: exact weights
        # log q - log base (VIQR) / fmu_s - log base (IMIQR); otherwise
        # keep the proposal-weighted set.
        Xa = jnp.where(need, Xa_c, Xa)
        fmu = jnp.where(need, fmu_c, fmu)
        fs2 = jnp.where(need, fs2_c, fs2)
        if acq_name == "viqr":
            logq = vp_log_pdf_trans(vp, Xa)
            lnw_ref = (logq - lnb_c)[None, :] + jnp.zeros_like(fmu)
            lnw_prop = logq[None, :] - log_prop[None, :] + jnp.zeros_like(fmu)
        else:
            lnw_ref = fmu - lnb_c[None, :]
            lnw_prop = fmu - log_prop[None, :]
        lnw = jnp.where(need, lnw_ref, lnw_prop)
    else:
        if acq_name == "viqr":
            # Variational IQR: weights ~ q(x) / proposal; the f-dependent
            # part enters through the sinh term at evaluation time.
            logq = vp_log_pdf_trans(vp, Xa)
            lnw = logq[None, :] - log_prop[None, :] + jnp.zeros_like(fmu)
        else:
            # IMIQR: weights = fixed integrand / proposal = fmu - ln prop
            # (`ais:318-323` islogf1; the sinh factor enters at eval time).
            lnw = fmu - log_prop[None, :]

    lnw = jnp.where(jnp.isfinite(lnw), lnw, -jnp.inf)
    # Normalize per sample (log-mean-exp).
    lnw = lnw - jax.scipy.special.logsumexp(
        lnw, axis=1, keepdims=True)

    # Precompute B^{-1} k(X, Xa) per sample (ais:247-278).
    def pre(hyp, Binv):
        ks = kernel_cross(cfg, hyp, gp.X, Xa) * \
            gp.mask.astype(dtype)[:, None]
        return Binv @ ks                               # (N, Na)

    invKzk = jax.vmap(pre)(gp.hyp, gp.Binv)
    return ISState(Xa=Xa, ln_weights=lnw, invKzk=invKzk, f_s2=fs2)


@partial(jax.jit, static_argnames=("cfg", "name"))
def evaluate_is_acquisition(cfg: GPConfig, name: str, Xs: jnp.ndarray,
                            vp: VariationalPosterior, gp: GP, state,
                            ais: ISState) -> jnp.ndarray:
    """VIQR/IMIQR acquisition for candidate batch Xs (M, D): negative
    expected reduction of the integrated median IQR
    (`acqviqr_vbmc.m:60-121`). Lower is better.
    """
    from vbmc_tpu.acquisitions import _nearest_noise
    from vbmc_tpu.gp.predict import gp_predict

    dtype = Xs.dtype
    fbar, vtot, fmu, fs2 = gp_predict(cfg, gp, Xs)
    sn2 = _nearest_noise(cfg, gp, Xs, state)            # (M,)

    # Posterior covariance between candidates and integration points, per
    # hyp sample: cov_m,a = k(x_m, x_a) - k(x_m, X) B^{-1} k(X, x_a).
    def cov_one(hyp, L, invK):
        kma = kernel_cross(cfg, hyp, Xs, ais.Xa)        # (M, Na)
        kmx = kernel_cross(cfg, hyp, Xs, gp.X) * \
            gp.mask.astype(dtype)[None, :]              # (M, N)
        return kma - kmx @ invK                         # (M, Na)

    cov = jax.vmap(cov_one)(gp.hyp, gp.L, ais.invKzk)   # (S, M, Na)

    # Variance reduction at integration points after observing x_m:
    # s2_new(a) = s2(a) - cov^2 / (fs2(m) + sn2(m)).
    denom = fs2 + sn2[None, :]                          # (S, M)
    red = cov ** 2 / denom[:, :, None]                  # (S, M, Na)
    s2_post = jnp.maximum(ais.f_s2[:, None, :] - red, 1e-12)

    # IQR factor: 2*sinh(u * s) integrated under the IS weights
    # (`acqviqr_vbmc.m:100-108`); minimizing the post-observation integrated
    # IQR maximizes information about the posterior mass.
    ln_sinh_post = jnp.log(2.0) + _log_sinh(_U_IQR * jnp.sqrt(s2_post))
    lnw = ais.ln_weights[:, None, :]                    # (S, 1, Na)
    ln_integral = jax.scipy.special.logsumexp(lnw + ln_sinh_post, axis=2)

    # Average over hyperparameter samples in log space
    # (`acqviqr_vbmc.m:111-114`), masked log-mean-exp.
    m = gp.hyp_mask.astype(dtype)
    ns = jnp.maximum(jnp.sum(m), 1.0)
    neg_big = jnp.finfo(dtype).min
    ln_masked = jnp.where(m[:, None] > 0, ln_integral, neg_big)
    acq = (jax.scipy.special.logsumexp(ln_masked, axis=0)
           - jnp.log(ns))                               # (M,) log-domain

    low = vtot < state.tol_var
    ratio = state.tol_var / jnp.maximum(vtot, jnp.finfo(vtot.dtype).tiny)
    acq = jnp.where(state.regularize & low, acq + ratio - 1.0, acq)

    from vbmc_tpu.transforms import inverse
    X_orig = inverse(vp.trinfo, Xs)
    out = (jnp.any(X_orig < state.lb_eps_orig[None, :], axis=1)
           | jnp.any(X_orig > state.ub_eps_orig[None, :], axis=1))
    return jnp.where(out, jnp.inf, acq)


def _log_sinh(x):
    """Numerically stable log(sinh(x)) for x >= 0."""
    return x + jnp.log1p(-jnp.exp(-2.0 * x)) - jnp.log(2.0)
