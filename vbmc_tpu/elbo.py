"""The Bayesian-quadrature ELBO: expected GP log-joint under the mixture
posterior, entropy estimators, and the negative ELCBO objective.

This is the heart of VBMC (cf. `misc/gplogjoint.m`, `ent/entlb_vbmc.m`,
`ent/entmc_vbmc.m`, `misc/negelcbo_vbmc.m`). Batched design:

- The (hyp-sample S, mixture-component K, training-point N) loops of the
  reference become one einsum-shaped batch; the S axis is the natural shard
  axis on a device mesh.
- All gradients (including the reparameterization-trick entropy gradient and
  the log/softmax parameter Jacobians the reference hand-derives) come from
  autodiff through the packed parameter vector.
- K and S are padded to buckets with masks; padded entries carry zero weight
  and drop out of every sum exactly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from vbmc_tpu.gp.config import (GPConfig, MEAN_ZERO, MEAN_CONST,
                                MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE,
                                MEAN_NEGQUADONLY, MEAN_NEGQUADLINONLY,
                                MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                                MEAN_NEGQUADSEFIX, MEAN_NEGQUADFIXONLY,
                                MEAN_NEGQUADMIX)
from vbmc_tpu.gp.gp import GP

import numpy as np

_LOG2PI = 1.8378770664093453


# ----------------------------------------------------------------------
# Parameter packing: theta <-> (mu, sigma, lambda, w)
# ----------------------------------------------------------------------

class VPFlags(NamedTuple):
    """Which variational parameter blocks are optimized (static)."""
    opt_mu: bool = True
    opt_sigma: bool = True
    opt_lambda: bool = True
    opt_weights: bool = False


def theta_size(flags: VPFlags, K: int, D: int) -> int:
    n = 0
    if flags.opt_mu:
        n += K * D
    if flags.opt_sigma:
        n += K
    if flags.opt_lambda:
        n += D
    if flags.opt_weights:
        n += K
    return n


def pack_theta(flags: VPFlags, mu, sigma, lam, eta):
    parts = []
    if flags.opt_mu:
        parts.append(mu.ravel())
    if flags.opt_sigma:
        parts.append(jnp.log(sigma))
    if flags.opt_lambda:
        parts.append(jnp.log(lam))
    if flags.opt_weights:
        parts.append(eta)
    return jnp.concatenate(parts)


def unpack_theta(flags: VPFlags, theta, K: int, D: int, mu0, sigma0, lam0,
                 w0, kmask):
    """Rebuild (mu, sigma, lam, w) from theta, applying the lambda/sigma
    rescaling invariance (`misc/rescale_params.m`: ||lam||^2 = D with sigma
    compensation) and masked-softmax weights."""
    i = 0
    if flags.opt_mu:
        mu = theta[:K * D].reshape(K, D)
        i = K * D
    else:
        mu = mu0
    if flags.opt_sigma:
        sigma = jnp.exp(theta[i:i + K])
        i += K
    else:
        sigma = sigma0
    if flags.opt_lambda:
        lam = jnp.exp(theta[i:i + D])
        i += D
    else:
        lam = lam0
    # Rescale: lambda normalized, sigma compensated.
    nl = jnp.sqrt(jnp.sum(lam ** 2) / D)
    lam = lam / nl
    sigma = sigma * nl
    if flags.opt_weights:
        eta = theta[i:i + K]
        from vbmc_tpu.vp import masked_softmax
        w = masked_softmax(eta, kmask)
    else:
        w = w0
    return mu, sigma, lam, w


# ----------------------------------------------------------------------
# Expected log joint under the GP (Bayesian quadrature)
# ----------------------------------------------------------------------

def _negquad_nu_at(xm, omega2, mu, sigma, lam):
    """E_q[-1/2 sum ((x - xm)/omega)^2] per (S, K): closed form
    (`gplogjoint.m:171-174`). xm, omega2: (S, D)."""
    s2lam2 = (sigma[:, None] ** 2) * (lam[None, :] ** 2)  # (K, D)
    quad = (mu[None, :, :] ** 2 + s2lam2[None, :, :]
            - 2.0 * mu[None, :, :] * xm[:, None, :]
            + xm[:, None, :] ** 2) / omega2[:, None, :]
    return -0.5 * jnp.sum(quad, axis=-1)           # (S, K)


def _negquad_nu(cfg: GPConfig, hyp_mean, mu, sigma, lam):
    D = cfg.D
    xm = hyp_mean[:, 1:D + 1]                      # (S, D)
    omega2 = jnp.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])  # (S, D)
    return _negquad_nu_at(xm, omega2, mu, sigma, lam)


def _se_bump_nu(xm, omega2, h, mu, sigma, lam):
    """E_q[h * exp(-1/2 sum ((x - xm)/omega)^2)] per (S, K)
    (`gplogjoint.m:175-179`). xm, omega2: (S, D); h: (S,)."""
    s2lam2 = (sigma[:, None] ** 2) * (lam[None, :] ** 2)
    tau2 = s2lam2[None, :, :] + omega2[:, None, :]  # (S, K, D)
    s2 = ((mu[None, :, :] - xm[:, None, :]) ** 2) / tau2
    lognf = 0.5 * jnp.sum(jnp.log(omega2[:, None, :]) - jnp.log(tau2), -1)
    return h[:, None] * jnp.exp(lognf - 0.5 * jnp.sum(s2, -1))


def _se_nu(cfg: GPConfig, hyp_mean, mu, sigma, lam):
    D = cfg.D
    xm = hyp_mean[:, 1:D + 1]
    omega2 = jnp.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])
    h = jnp.exp(hyp_mean[:, 2 * D + 1])            # (S,)
    return _se_bump_nu(xm, omega2, h, mu, sigma, lam)


def _z_matrix(cfg: GPConfig, gp: GP, mu, sigma, lam):
    """z_{s,k,n} = E_q_k[k(x, X_n)] for the SE-ard kernel
    (`gplogjoint.m:164-168`), masked over padded training rows.

    Memory-shaped as two (S,K,N) einsums — no (S,K,N,D) temporary.
    """
    from vbmc_tpu.gp.config import COV_SEARD
    if cfg.covfun != COV_SEARD:
        raise ValueError(
            "the Bayesian-quadrature ELBO requires the SE-ard kernel "
            "(covfun=1); seiso/Matérn are gplite-library families only, "
            "as in the reference (`gplogjoint.m` hard-codes SE-ard)")
    D = cfg.D
    log_ell = gp.hyp[:, :D]                       # (S, D)
    ell2 = jnp.exp(2.0 * log_ell)
    ln_sf2 = 2.0 * gp.hyp[:, D]                   # (S,)
    sum_lnell = jnp.sum(log_ell, axis=-1)         # (S,)

    s2lam2 = (sigma[:, None] ** 2) * (lam[None, :] ** 2)  # (K, D)
    tau2 = s2lam2[None, :, :] + ell2[:, None, :]          # (S, K, D)
    lnnf = ln_sf2[:, None] + sum_lnell[:, None] \
        - 0.5 * jnp.sum(jnp.log(tau2), axis=-1)           # (S, K)

    inv_tau2 = 1.0 / tau2                                  # (S, K, D)
    X = gp.X                                               # (N, D)
    # quad_skn = sum_d (mu_kd - X_nd)^2 / tau2_skd
    mu2_term = jnp.sum((mu[None, :, :] ** 2) * inv_tau2, axis=-1)  # (S, K)
    cross = jnp.einsum("skd,nd->skn", mu[None, :, :] * inv_tau2, X)
    x2 = jnp.einsum("skd,nd->skn", inv_tau2, X * X)
    quad = mu2_term[:, :, None] - 2.0 * cross + x2
    z = jnp.exp(lnnf[:, :, None] - 0.5 * quad)
    return z * gp.mask.astype(z.dtype)[None, None, :], lnnf, tau2


def _int_basis_expect(cfg: GPConfig, mu, sigma, lam):
    """E_{q_k}[h(x)] for the integrated-mean polynomial basis under each
    mixture component N(mu_k, sigma_k^2 Lambda^2) — closed form because the
    component covariance is diagonal. Returns (K, Nb).

    (New capability vs the reference: `misc/gplogjoint.m` has no integrated-
    mean support, so reference VBMC cannot combine `gpIntMeanFun` with the
    variational fit; here the quadrature is exact.)
    """
    from vbmc_tpu.gp.config import (INTMEAN_LINEAR, INTMEAN_QUAD,
                                    INTMEAN_FULLQUAD)
    import numpy as np
    K_max = mu.shape[0]
    cols = [jnp.ones((K_max, 1), dtype=mu.dtype)]
    if cfg.intmean >= INTMEAN_LINEAR:
        cols.append(mu)
    if cfg.intmean >= INTMEAN_QUAD:
        s2lam2 = (sigma[:, None] ** 2) * (lam[None, :] ** 2)
        cols.append(mu * mu + s2lam2)
    if cfg.intmean >= INTMEAN_FULLQUAD:
        iu, ju = np.triu_indices(cfg.D, k=1)
        cols.append(mu[:, iu] * mu[:, ju])
    return jnp.concatenate(cols, axis=1)


def _intmean_r(cfg: GPConfig, gp: GP, mu, sigma, lam, z):
    """Quadrature residual basis r_sk = E_k[h] - H B^{-1} E_k[k(.,X)],
    the integrated-mean analogue of R(x) in `gplite_pred.m:89-94` pushed
    through the component expectation. Returns (S, K, Nb)."""
    hbar = _int_basis_expect(cfg, mu, sigma, lam)          # (K, Nb)
    Hz = jnp.einsum("sbn,skn->skb", gp.HBinv, z)           # (S, K, Nb)
    return hbar[None, :, :] - Hz


def gplogjoint_I(cfg: GPConfig, gp: GP, mu, sigma, lam):
    """Per-sample, per-component expected log joint I_sk (S_max, K_max)."""
    z, _, _ = _z_matrix(cfg, gp, mu, sigma, lam)
    I = jnp.einsum("skn,sn->sk", z, gp.alpha)
    hyp_mean = gp.hyp[:, cfg.sl_mean]
    if cfg.meanfun == MEAN_CONST:
        I = I + hyp_mean[:, 0][:, None]
    elif cfg.meanfun == MEAN_NEGQUAD:
        I = I + hyp_mean[:, 0][:, None] + _negquad_nu(cfg, hyp_mean, mu, sigma, lam)
    elif cfg.meanfun == MEAN_SE:
        I = I + hyp_mean[:, 0][:, None] + _se_nu(cfg, hyp_mean, mu, sigma, lam)
    elif cfg.meanfun == MEAN_NEGQUADSE:
        D = cfg.D
        xm = hyp_mean[:, 1:D + 1]
        omega2 = jnp.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])
        xm_se = hyp_mean[:, 2 * D + 1:3 * D + 1]
        omega2_se = jnp.exp(2.0 * hyp_mean[:, 3 * D + 1:4 * D + 1])
        h_se = hyp_mean[:, 4 * D + 1]              # raw height
        I = (I + hyp_mean[:, 0][:, None]
             + _negquad_nu_at(xm, omega2, mu, sigma, lam)
             + _se_bump_nu(xm_se, omega2_se, h_se, mu, sigma, lam))
    elif cfg.meanfun == MEAN_NEGQUADONLY:
        omega2 = jnp.exp(2.0 * hyp_mean[:, :cfg.D])
        I = I + _negquad_nu_at(jnp.zeros_like(omega2), omega2, mu, sigma, lam)
    elif cfg.meanfun == MEAN_NEGQUADLINONLY:
        xm = hyp_mean[:, :cfg.D]
        omega2 = jnp.exp(2.0 * hyp_mean[:, cfg.D:2 * cfg.D])
        I = I + _negquad_nu_at(xm, omega2, mu, sigma, lam)
    elif cfg.meanfun in (MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                         MEAN_NEGQUADSEFIX, MEAN_NEGQUADFIXONLY):
        # Fixed-center families: the center is the static per-fit constant
        # cfg.fix_center (`gplogjoint.m:112-121,134-138`).
        from vbmc_tpu.gp.means import _center
        D = cfg.D
        S = hyp_mean.shape[0]
        xm = jnp.broadcast_to(_center(cfg, mu.dtype), (S, D))
        if cfg.meanfun == MEAN_NEGQUADFIXISO:
            omega2 = jnp.broadcast_to(jnp.exp(2.0 * hyp_mean[:, 1])[:, None],
                                      (S, D))
            I = I + hyp_mean[:, 0][:, None] \
                + _negquad_nu_at(xm, omega2, mu, sigma, lam)
        elif cfg.meanfun == MEAN_NEGQUADFIXONLY:
            omega2 = jnp.exp(2.0 * hyp_mean[:, :D])
            I = I + _negquad_nu_at(xm, omega2, mu, sigma, lam)
        else:
            omega2 = jnp.exp(2.0 * hyp_mean[:, 1:D + 1])
            I = I + hyp_mean[:, 0][:, None] \
                + _negquad_nu_at(xm, omega2, mu, sigma, lam)
            if cfg.meanfun == MEAN_NEGQUADSEFIX:
                # Constrained SE bump: omega_se = alpha*omega, plus the
                # -h_se offset folded into m0 (`gplogjoint.m:134-138`).
                alpha2 = jnp.exp(2.0 * hyp_mean[:, D + 1])
                h_se = jnp.exp(hyp_mean[:, D + 2])
                I = (I - h_se[:, None]
                     + _se_bump_nu(xm, alpha2[:, None] * omega2, h_se,
                                   mu, sigma, lam))
    elif cfg.meanfun == MEAN_NEGQUADMIX:
        # E_q of the quadratic mixture (`gplogjoint.m:181-195`): the window
        # term needs the Gaussian-tilted first/second moments of q_k.
        D = cfg.D
        xm = hyp_mean[:, 1:D + 1]
        omega2 = jnp.exp(2.0 * hyp_mean[:, D + 1:2 * D + 1])
        hm = hyp_mean[:, 2 * D + 1]
        rho2 = jnp.exp(2.0 * hyp_mean[:, 2 * D + 2])
        beta2 = jnp.exp(2.0 * hyp_mean[:, 2 * D + 3])
        s2lam2 = (sigma[:, None] ** 2) * (lam[None, :] ** 2)   # (K, D)
        # nu1 = (1/beta2) * E[-q/2]
        nu1 = _negquad_nu_at(xm, omega2, mu, sigma, lam) / beta2[:, None]
        # E[window] = prod_d sqrt(rho2 w_d2 / t2_d) exp(-(mu-xm)^2/(2 t2))
        t2 = s2lam2[None, :, :] + rho2[:, None, None] * omega2[:, None, :]
        s2 = ((mu[None, :, :] - xm[:, None, :]) ** 2) / t2
        lognf = 0.5 * jnp.sum(
            jnp.log(rho2[:, None, None] * omega2[:, None, :])
            - jnp.log(t2), -1)
        atil = jnp.exp(lognf - 0.5 * jnp.sum(s2, -1))          # (S, K)
        nu2 = -hm[:, None] * atil
        # Tilted moments: q_k * window is Gaussian with
        #   var  = s2lam2 * rho2 w2 / t2,   mean = (xm s2lam2 + mu rho2 w2)/t2
        mutil = (xm[:, None, :] * s2lam2[None, :, :]
                 + mu[None, :, :] * rho2[:, None, None] * omega2[:, None, :]) / t2
        vartil = s2lam2[None, :, :] * rho2[:, None, None] \
            * omega2[:, None, :] / t2
        qtil = jnp.sum((vartil + (mutil - xm[:, None, :]) ** 2)
                       / omega2[:, None, :], -1)               # (S, K)
        nu3 = -0.5 * (1.0 - 1.0 / beta2)[:, None] * atil * qtil
        I = I + (hyp_mean[:, 0] + hm)[:, None] + nu1 + nu2 + nu3
    elif cfg.meanfun != MEAN_ZERO:
        raise ValueError("gplogjoint supports zero/const/negquad/se/"
                         "negquadse/negquad(fix/fixiso/sefix/fixonly)/"
                         "negquadonly/negquadlinonly/negquadmix means")
    if cfg.nint > 0:
        r = _intmean_r(cfg, gp, mu, sigma, lam, z)
        I = I + jnp.einsum("skb,sb->sk", r, gp.betabar)
    return I


def gplogjoint_J(cfg: GPConfig, gp: GP, mu, sigma, lam, kmask):
    """Full K x K posterior covariance of the quadrature integral per sample:
    J_sjk (`gplogjoint.m:306-339`)."""
    D = cfg.D
    z, lnnf, _ = _z_matrix(cfg, gp, mu, sigma, lam)        # (S, K, N)
    log_ell = gp.hyp[:, :D]
    ell2 = jnp.exp(2.0 * log_ell)
    ln_sf2 = 2.0 * gp.hyp[:, D]
    sum_lnell = jnp.sum(log_ell, axis=-1)

    # Prior term: tau2_jk,d = (sigma_j^2 + sigma_k^2) lam_d^2 + ell_d^2
    ss2 = sigma[:, None] ** 2 + sigma[None, :] ** 2        # (K, K)
    K_max = mu.shape[0]
    S_max = gp.hyp.shape[0]
    logdet = jnp.zeros((S_max, K_max, K_max), dtype=mu.dtype)
    quad = jnp.zeros((S_max, K_max, K_max), dtype=mu.dtype)
    for d in range(D):  # D is small and static; avoids an (S,K,K,D) temp
        tau2_d = ss2 * lam[d] ** 2 + ell2[:, d][:, None, None]  # (S, K, K)
        logdet = logdet + jnp.log(tau2_d)
        dmu = (mu[:, d][:, None] - mu[None, :, d]) ** 2         # (K, K)
        quad = quad + dmu[None, :, :] / tau2_d
    lnnf_jk = (ln_sf2[:, None, None] + sum_lnell[:, None, None]
               - 0.5 * logdet)
    prior_term = jnp.exp(lnnf_jk - 0.5 * quad)

    # Data correction: z_j^T B^{-1} z_k per sample. Uses the Cholesky solve,
    # not the explicit inverse: J is a small difference of large terms and
    # the inverse squares the condition number — in float32 that inflates
    # the ELBO uncertainty by orders of magnitude (observed; keep L here,
    # Binv is for the prediction/IS sweeps where cancellation is mild).
    def corr(L, zs):
        U = cho_solve((L, True), zs.T)        # (N, K)
        return zs @ U                         # (K, K)

    data_term = jax.vmap(corr)(gp.L, z)
    J = prior_term - data_term
    if cfg.nint > 0:
        # Integrated-mean covariance: + r_j^T A^{-1} r_k (the bilinear form
        # factorizes through the double integral, so the correction is exact).
        r = _intmean_r(cfg, gp, mu, sigma, lam, z)         # (S, K, Nb)
        J = J + jnp.einsum("sjb,sbc,skc->sjk", r, gp.Ainv, r)
    mK = kmask.astype(J.dtype)
    return J * mK[None, :, None] * mK[None, None, :]


def _sample_stats(x, hyp_mask):
    """Masked mean/variance over the hyperparameter-sample axis (axis 0)."""
    m = hyp_mask.astype(x.dtype)
    ns = jnp.maximum(jnp.sum(m), 1.0)
    shape = (slice(None),) + (None,) * (x.ndim - 1)
    mw = m[shape]
    mean = jnp.sum(x * mw, axis=0) / ns
    var = jnp.where(ns > 1,
                    jnp.sum(((x - mean) ** 2) * mw, axis=0)
                    / jnp.maximum(ns - 1.0, 1.0),
                    jnp.zeros_like(mean))
    return mean, var, ns


def gplogjoint(cfg: GPConfig, gp: GP, mu, sigma, lam, w, kmask,
               compute_var: int = 0):
    """Expected log joint G (scalar), averaged over hyperparameter samples.

    compute_var: 0 = no variance; 1 = full K x K covariance; 2 = diagonal
    only (self-variances), as in the reference.
    Returns (G, varG, varG_samples, I_sk, J_sjk).
    """
    I = gplogjoint_I(cfg, gp, mu, sigma, lam)      # (S, K)
    wk = w * kmask.astype(w.dtype)
    F_s = I @ wk                                   # (S,)
    G, varF_ss, ns = _sample_stats(F_s, gp.hyp_mask)

    if compute_var == 0:
        return G, jnp.zeros(()), varF_ss, I, None

    J = gplogjoint_J(cfg, gp, mu, sigma, lam, kmask)   # (S, K, K)
    eps = jnp.finfo(J.dtype).eps
    diag = jnp.clip(jnp.diagonal(J, axis1=1, axis2=2), eps, None)
    if compute_var == 2:
        varF_s = jnp.sum((wk ** 2) * diag, axis=-1)
    else:
        J_sym = J.at[:, jnp.arange(J.shape[1]), jnp.arange(J.shape[2])].set(diag)
        varF_s = jnp.einsum("j,sjk,k->s", wk, J_sym, wk)
    varF_s = jnp.maximum(varF_s, eps)
    varF_mean, varF_var, _ = _sample_stats(varF_s, gp.hyp_mask)
    varG = varF_mean + varF_ss
    varss = varF_ss + jnp.sqrt(varF_var)
    return G, varG, varss, I, J


# ----------------------------------------------------------------------
# Entropy estimators
# ----------------------------------------------------------------------

def entropy_lower_bound(mu, sigma, lam, w, kmask):
    """Deterministic entropy lower bound (Gershman et al. 2012;
    `ent/entlb_vbmc.m:66-127`), with a branchless exact-entropy correction
    when only one component is active."""
    D = mu.shape[1]
    dtype = mu.dtype
    m = kmask.astype(dtype)
    ss2 = sigma[:, None] ** 2 + sigma[None, :] ** 2        # (K, K)
    d2 = jnp.sum(((mu[:, None, :] - mu[None, :, :]) / lam[None, None, :]) ** 2,
                 axis=-1) / ss2                            # (K, K)
    log_nconst = -0.5 * D * _LOG2PI - jnp.sum(jnp.log(lam))
    log_gamma = log_nconst - 0.5 * D * jnp.log(ss2) - 0.5 * d2
    # gammasum_j = sum_k w_k gamma_jk over active k
    wk = w * m
    gamma_max = jnp.max(jnp.where(m[None, :] > 0, log_gamma, -jnp.inf),
                        axis=1, keepdims=True)
    gsum = jnp.sum(wk[None, :] * jnp.exp(log_gamma - gamma_max), axis=1)
    log_gsum = jnp.log(jnp.maximum(gsum, jnp.finfo(gsum.dtype).tiny)) + gamma_max[:, 0]
    H = -jnp.sum(jnp.where(kmask, w * log_gsum, 0.0))
    # Exact-entropy correction for a single active component
    # (`entlb_vbmc.m:32-47`): H_exact - H_lb = D/2 (1 - log 2).
    n_active = jnp.sum(m)
    H = H + jnp.where(n_active == 1, 0.5 * D * (1.0 - jnp.log(2.0)), 0.0)
    return H


def entropy_mc(key, mu, sigma, lam, w, kmask, n_per_k: int):
    """Monte-Carlo entropy with antithetic sampling (`ent/entmc_vbmc.m`).

    Differentiable in (mu, sigma, lam, w) via the reparameterization trick
    (autodiff replaces the hand-derived gradients of the reference).
    """
    K_max, D = mu.shape
    dtype = mu.dtype
    half = max(n_per_k // 2, 1)
    eps_half = jax.random.normal(key, (K_max, half, D), dtype=dtype)
    eps = jnp.concatenate([eps_half, -eps_half], axis=1)   # (K, 2*half, D)
    xi = mu[:, None, :] + (sigma[:, None, None] * lam[None, None, :]) * eps

    # log q(xi) for all samples: (K_j, n, K_k) distances
    scale = sigma[:, None] * lam[None, :]                  # (K, D)
    z2 = jnp.sum(((xi[:, :, None, :] - mu[None, None, :, :])
                  / scale[None, None, :, :]) ** 2, axis=-1)  # (Kj, n, Kk)
    log_norm = (-0.5 * D * _LOG2PI - jnp.sum(jnp.log(scale), axis=-1))
    comp = log_norm[None, None, :] - 0.5 * z2
    logw = jnp.where(kmask, jnp.log(jnp.maximum(w, jnp.finfo(w.dtype).tiny)),
                     jnp.finfo(dtype).min)
    logq = jax.scipy.special.logsumexp(comp + logw[None, None, :], axis=-1)
    mean_logq = jnp.mean(logq, axis=1)                     # (K,)
    H = -jnp.sum(jnp.where(kmask, w * mean_logq, 0.0))
    return H


def entropy_upper_bound(mu, sigma, lam, w, kmask):
    """Gaussian moment-matching upper bound on the mixture entropy
    (cf. `ent/entub_vbmc.m`): the entropy of a Gaussian with the mixture's
    covariance upper-bounds the mixture entropy."""
    D = mu.shape[1]
    wk = w * kmask.astype(w.dtype)
    mean = jnp.sum(wk[:, None] * mu, axis=0)
    dmu = mu - mean
    cov = (dmu * wk[:, None]).T @ dmu
    cov = cov + jnp.diag(jnp.sum(wk * sigma ** 2) * lam ** 2)
    sign, logdet = jnp.linalg.slogdet(cov)
    return 0.5 * D * (1.0 + _LOG2PI) + 0.5 * logdet


# ----------------------------------------------------------------------
# Soft bounds on variational parameters
# ----------------------------------------------------------------------

class ThetaBounds(NamedTuple):
    """Soft-bound data for the extended parameterization
    (`misc/vpbounds.m`): per-dim mu bounds, per-dim log-scale
    (sigma*lambda) bounds, eta bounds, plus weight-penalty constants."""
    mu_lb: jnp.ndarray        # (D,)
    mu_ub: jnp.ndarray        # (D,)
    lnscale_lb: jnp.ndarray   # (D,)
    lnscale_ub: jnp.ndarray   # (D,)
    eta_lb: jnp.ndarray       # ()
    eta_ub: jnp.ndarray       # ()
    tol_con: float
    weight_threshold: jnp.ndarray  # ()
    weight_penalty: float


def compute_vp_bounds(gp: GP, options, K: int) -> "ThetaBounds":
    """Soft bounds from the training-point hull (`vpbounds.m:17-30`).

    Host math on the X/mask mirrors: this runs once per vpoptimize call
    and the eager-jnp version dispatched ~8 device ops each time. The
    numpy leaves upload when
    the bounds enter a jitted objective."""
    from vbmc_tpu.utils.hostcache import to_np
    dtype = np.dtype(gp.X.dtype)
    X = np.asarray(to_np(gp.X), dtype=float)
    m = np.asarray(to_np(gp.mask), bool)
    Xa = X[m] if m.any() else X
    Xmin = Xa.min(axis=0).astype(dtype)
    Xmax = Xa.max(axis=0).astype(dtype)
    lnrange = np.log(np.maximum(Xmax - Xmin, 1e-10)).astype(dtype)
    return ThetaBounds(
        mu_lb=Xmin, mu_ub=Xmax,
        lnscale_lb=(lnrange + np.log(options.tol_length)).astype(dtype),
        lnscale_ub=lnrange,
        eta_lb=dtype.type(np.log(0.5 * options.tol_weight)),
        eta_ub=dtype.type(0.0),
        tol_con=options.tol_con_loss,
        weight_threshold=dtype.type(max(1.0 / (4 * K), options.tol_weight)),
        weight_penalty=options.weight_penalty,
    )


def _softbnd(x, lb, ub, tol):
    ell = (ub - lb) * tol
    lo = jnp.maximum(lb - x, 0.0) / ell
    hi = jnp.maximum(x - ub, 0.0) / ell
    return 0.5 * jnp.sum(lo * lo + hi * hi)


def vp_bound_loss(flags: VPFlags, bnd: ThetaBounds, mu, sigma, lam, eta, w,
                  kmask):
    """Soft-bound hinge loss + small-weight penalty
    (`misc/vpbndloss.m`, `negelcbo_vbmc.m:136-163`)."""
    m = kmask.astype(mu.dtype)
    L = jnp.zeros(())
    if flags.opt_mu:
        lo = jnp.maximum(bnd.mu_lb[None, :] - mu, 0.0)
        hi = jnp.maximum(mu - bnd.mu_ub[None, :], 0.0)
        ell = (bnd.mu_ub - bnd.mu_lb) * bnd.tol_con
        L = L + 0.5 * jnp.sum(m[:, None] * ((lo / ell) ** 2 + (hi / ell) ** 2))
    if flags.opt_sigma or flags.opt_lambda:
        lnscale = jnp.log(sigma)[:, None] + jnp.log(lam)[None, :]  # (K, D)
        ell = (bnd.lnscale_ub - bnd.lnscale_lb) * bnd.tol_con
        lo = jnp.maximum(bnd.lnscale_lb[None, :] - lnscale, 0.0)
        hi = jnp.maximum(lnscale - bnd.lnscale_ub[None, :], 0.0)
        L = L + 0.5 * jnp.sum(m[:, None] * ((lo / ell) ** 2 + (hi / ell) ** 2))
    if flags.opt_weights:
        # Weight-size penalty.
        wclip = jnp.where(w < bnd.weight_threshold, w, bnd.weight_threshold)
        L = L + jnp.sum(m * wclip) * bnd.weight_penalty
    return L


# ----------------------------------------------------------------------
# Negative EL(C)BO objective
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "flags", "n_ent_per_k",
                                   "compute_var", "use_bounds"))
def negelcbo(cfg: GPConfig, theta, gp: GP, mu0, sigma0, lam0, w0, kmask,
             flags: VPFlags, beta, n_ent_per_k: int, compute_var: int,
             key, bnd: Optional[ThetaBounds] = None,
             use_bounds: bool = False):
    """Negative ELCBO F = -(G + H) + beta*sqrt(varF) (+ soft-bound loss).

    Fully differentiable in theta; use jax.grad/value_and_grad.
    Returns (F, aux) with aux = (G, H, varF, varss).
    """
    K_max, D = mu0.shape
    mu, sigma, lam, w = unpack_theta(flags, theta, K_max, D, mu0, sigma0,
                                     lam0, w0, kmask)
    G, varG, varss, I, J = gplogjoint(cfg, gp, mu, sigma, lam, w, kmask,
                                      compute_var=compute_var)
    if n_ent_per_k > 0:
        H = entropy_mc(key, mu, sigma, lam, w, kmask, n_ent_per_k)
    else:
        H = entropy_lower_bound(mu, sigma, lam, w, kmask)
    F = -G - H
    varF = varG
    # max(., tiny) keeps sqrt's gradient finite so the unselected `where`
    # branch cannot poison the beta == 0 path with NaNs.
    F = jnp.where(beta != 0, F + beta * jnp.sqrt(jnp.maximum(varF, 1e-30)), F)
    if use_bounds and bnd is not None:
        eta = theta[-K_max:] if flags.opt_weights else jnp.zeros(K_max)
        F = F + vp_bound_loss(flags, bnd, mu, sigma, lam, eta, w, kmask)
    return F, (G, H, varF, varss)


@partial(jax.jit, static_argnames=("cfg", "flags", "n_ent_per_k",
                                   "compute_var"))
def elbo_stats(cfg: GPConfig, theta, gp: GP, mu0, sigma0, lam0, w0, kmask,
               flags: VPFlags, n_ent_per_k: int, compute_var: int, key):
    """Precise EL(C)BO evaluation with full variance and per-component
    quadrature stats (cf. `vpoptimize_vbmc.m:257-304` eval_fullelcbo).

    Returns dict with elbo, G, H, varF, varss, I_sk, J_sjk.
    """
    K_max, D = mu0.shape
    mu, sigma, lam, w = unpack_theta(flags, theta, K_max, D, mu0, sigma0,
                                     lam0, w0, kmask)
    G, varG, varss, I, J = gplogjoint(cfg, gp, mu, sigma, lam, w, kmask,
                                      compute_var=compute_var)
    if n_ent_per_k > 0:
        H = entropy_mc(key, mu, sigma, lam, w, kmask, n_ent_per_k)
    else:
        H = entropy_lower_bound(mu, sigma, lam, w, kmask)
    varF = varG
    return dict(elbo=G + H, G=G, H=H, varF=varF, varss=varss, I_sk=I,
                J_sjk=J if J is not None else jnp.zeros(()),
                mu=mu, sigma=sigma, lam=lam, w=w)
