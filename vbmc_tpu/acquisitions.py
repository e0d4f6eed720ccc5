"""Acquisition functions for active sampling (cf. `acq/*.m`).

One jitted batched evaluator per acquisition type: the 2^13-candidate sweep
is a single fused kernel (GP predict + mixture pdf + acquisition + variance
regularization + bound check), the natural unit to shard across a device
mesh. CMA-ES refinement reuses the same evaluator on its population batches.

Acquisition names:
  "prospective"      acqf_vbmc      -vtot * exp(fbar - ymax) * q(x)
  "prospective_sn2"  acqfsn2_vbmc   noise-corrected variant (noisy targets)
  "prospective_log"  acqflog_vbmc   log-domain variant
  "us"               acqus_vbmc     -vtot * q(x)^2
  "eig"              acqeig_vbmc    expected information gain
  "viqr" / "imiqr"   importance-sampling variants (see active_is.py)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.gp import GP
from vbmc_tpu.gp.predict import gp_predict
from vbmc_tpu.vp import VariationalPosterior, vp_log_pdf_trans
from vbmc_tpu.transforms import inverse

_LOG_REALMIN = -708.0


class AcqState(NamedTuple):
    """Traced state needed by acquisition evaluations."""
    ymax: jnp.ndarray            # () max observed log joint (transformed)
    tol_var: jnp.ndarray         # () GP variance regularization threshold
    lb_eps_orig: jnp.ndarray     # (D,) hard-bound epsilon box (original)
    ub_eps_orig: jnp.ndarray     # (D,)
    gp_length_scale: jnp.ndarray  # (D,) geometric-mean GP length scales
    var_log_joint: jnp.ndarray   # (S_max,) per-sample var of log joint (eig)
    regularize: jnp.ndarray      # () bool
    # Bandwidth smoothing SDs (options.bandwidth * (PUB-PLB), the vp.delta
    # of `acqwrapper_vbmc.m:12-15`); None/zeros = off.
    delta: jnp.ndarray = None


ACQ_INFO = {
    "prospective": dict(log_flag=False, importance_sampling=False,
                        compute_varlogjoint=False, mcmc_importance_sampling=False),
    "prospective_sn2": dict(log_flag=False, importance_sampling=False,
                            compute_varlogjoint=False, mcmc_importance_sampling=False),
    "prospective_log": dict(log_flag=True, importance_sampling=False,
                            compute_varlogjoint=False, mcmc_importance_sampling=False),
    "us": dict(log_flag=False, importance_sampling=False,
               compute_varlogjoint=False, mcmc_importance_sampling=False),
    "eig": dict(log_flag=False, importance_sampling=False,
                compute_varlogjoint=True, mcmc_importance_sampling=False),
    "viqr": dict(log_flag=True, importance_sampling=True,
                 compute_varlogjoint=False, mcmc_importance_sampling=True),
    "imiqr": dict(log_flag=True, importance_sampling=True,
                  compute_varlogjoint=False, mcmc_importance_sampling=True),
}


def _nearest_noise(cfg: GPConfig, gp: GP, Xs, state: AcqState):
    """Observation-noise estimate at Xs from the nearest training point in
    length-scale-rescaled coordinates (`acqfsn2_vbmc.m:9-11`)."""
    Xr = Xs / state.gp_length_scale
    Tr = gp.X / state.gp_length_scale
    d2 = (jnp.sum(Xr * Xr, 1)[:, None] + jnp.sum(Tr * Tr, 1)[None, :]
          - 2.0 * Xr @ Tr.T)
    big = jnp.finfo(d2.dtype).max
    d2 = jnp.where(gp.mask[None, :], d2, big)
    pos = jnp.argmin(d2, axis=1)
    m = gp.hyp_mask.astype(gp.sn2.dtype)
    sn2_mean = jnp.sum(gp.sn2 * m[:, None], axis=0) / jnp.maximum(jnp.sum(m), 1)
    return sn2_mean[pos]


@partial(jax.jit, static_argnames=("cfg", "name", "smooth"))
def evaluate_acquisition(cfg: GPConfig, name: str, Xs: jnp.ndarray,
                         vp: VariationalPosterior, gp: GP, state: AcqState,
                         smooth: bool = False):
    """Batched acquisition values at candidate points Xs (M, D).

    Applies variance regularization (`acqwrapper_vbmc.m:35-45`) and the
    hard-bound rejection (`:50-52`). Lower is better. With ``smooth`` the
    GP summary comes from Bayesian quadrature against N(x, delta^2)
    smoothing kernels instead of point prediction
    (`acqwrapper_vbmc.m:12-15`, options.Bandwidth > 0).
    """
    if smooth:
        from vbmc_tpu.gp.quad import gp_quad
        fmu, fs2 = gp_quad(cfg, gp, Xs, state.delta)
        m = gp.hyp_mask.astype(fmu.dtype)[:, None]
        ns = jnp.maximum(jnp.sum(m), 1.0)
        fbar = jnp.sum(fmu * m, axis=0) / ns
        vbar = jnp.sum(fs2 * m, axis=0) / ns
        vf = jnp.where(ns > 1,
                       jnp.sum(((fmu - fbar) ** 2) * m, axis=0)
                       / jnp.maximum(ns - 1.0, 1.0), jnp.zeros_like(fbar))
        vtot = vbar + vf
    else:
        fbar, vtot, fmu, fs2 = gp_predict(cfg, gp, Xs)
    info = ACQ_INFO[name]
    log_flag = info["log_flag"]

    logp = jnp.maximum(vp_log_pdf_trans(vp, Xs), _LOG_REALMIN)

    if name == "prospective":
        acq = -vtot * jnp.exp(fbar - state.ymax + logp)
    elif name == "prospective_sn2":
        sn2 = _nearest_noise(cfg, gp, Xs, state)
        acq = -vtot * (1.0 - sn2 / (vtot + sn2)) * \
            jnp.exp(fbar - state.ymax + logp)
    elif name == "prospective_log":
        acq = -(jnp.log(jnp.maximum(vtot, jnp.finfo(vtot.dtype).tiny)) + fbar - state.ymax + logp)
    elif name == "us":
        acq = -vtot * jnp.exp(2.0 * logp)
    elif name == "eig":
        from vbmc_tpu.active_is import int_kernel
        sn2 = _nearest_noise(cfg, gp, Xs, state)
        intK = int_kernel(cfg, gp, vp, Xs)            # (S, M)
        ys2 = fs2 + sn2[None, :]
        rho2 = intK ** 2 / (state.var_log_joint[:, None] * ys2)
        rho2 = jnp.minimum(rho2, 1.0)
        m = gp.hyp_mask.astype(fbar.dtype)
        ns = jnp.maximum(jnp.sum(m), 1.0)
        acq = 0.5 * jnp.sum(
            jnp.log(jnp.maximum(1.0 - rho2, jnp.finfo(rho2.dtype).tiny)) * m[:, None], axis=0) / ns
    else:
        raise ValueError(f"unknown acquisition {name!r}")

    # Variance regularization below TolGPVar.
    low = vtot < state.tol_var
    ratio = state.tol_var / jnp.maximum(vtot, jnp.finfo(vtot.dtype).tiny)
    if log_flag:
        acq = jnp.where(state.regularize & low, acq + ratio - 1.0, acq)
    else:
        acq = jnp.where(state.regularize & low,
                        acq * jnp.exp(-(ratio - 1.0)), acq)
    acq = jnp.maximum(acq, -jnp.finfo(acq.dtype).max)

    # Reject points too close to the hard bounds (in original space).
    X_orig = inverse(vp.trinfo, Xs)
    out = (jnp.any(X_orig < state.lb_eps_orig[None, :], axis=1)
           | jnp.any(X_orig > state.ub_eps_orig[None, :], axis=1))
    return jnp.where(out, jnp.inf, acq)
