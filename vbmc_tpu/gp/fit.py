"""GP hyperparameter training: space-filling init, MAP optimization, and
parallel-chain slice sampling of the hyperparameter posterior.

Pipeline parity with `misc/gptrain_vbmc.m` + `gplite/gplite_train.m`, but
batch-shaped: the init design is one vmapped batch of marginal-likelihood
evaluations; MAP runs as a vmapped bounded L-BFGS over multiple starts; the
hyperparameter ensemble comes from several short parallel slice-sampling
chains (a vmap axis — shardable over devices) instead of one long thinned
chain.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.gp.config import (
    GPConfig, MEAN_NEGQUAD, MEAN_CONST, MEAN_SE, MEAN_NEGQUADFIXISO,
    MEAN_NEGQUADFIX, MEAN_NEGQUADSEFIX, MEAN_NEGQUADMIX)
from vbmc_tpu.gp import core
from vbmc_tpu.gp.gp import GP, HypPrior, build_gp
from vbmc_tpu.gp.means import mean_info
from vbmc_tpu.gp.noise import noise_info
from vbmc_tpu.gp.kernels import kernel_cross  # noqa: F401  (re-export)
from vbmc_tpu.samplers.slice import slice_sample_chain
from vbmc_tpu.optim import minimize_lbfgs_bounded
from vbmc_tpu.utils.math import bucket_n, bucket_ns, pad_to


@dataclasses.dataclass
class TrainOptions:
    ns_samples: int = 0          # GP hyperparameter samples (0 => MAP only)
    ninit: int = 1024            # space-filling design size (0 => skip)
    nopts: int = 2               # number of MAP optimization restarts
    thin: int = 5
    burnin: Optional[int] = None  # default: thin * ns_samples
    n_chains: int = 4
    widths: Optional[np.ndarray] = None   # sampler widths (from hyp cov)
    # True when the caller's widths carry a rindex inflation beyond the
    # base multiplier (unstable run): only then do they bypass the
    # design-derived cap (mode-hopping brackets are ~3x costlier/sweep).
    widths_escalated: bool = False
    lbfgs_iters: int = 80
    # Hyperprior knobs (cf. gptrain_vbmc / options):
    hpd_frac: float = 0.8
    tol_gp_noise: float = np.sqrt(1e-5)
    noise_size: Optional[float] = None
    length_prior_mean_mult: Optional[float] = None  # default sqrt(D/6)
    length_prior_std: float = 0.5 * np.log(1e3)
    quadratic_mean_bound: bool = True
    tol_sd: float = 0.1
    uncertainty_level: int = 0   # 0 exact; 1 infer noise; 2 provided noise
    upper_length_factor: float = 0.0
    # Output-warp ("fitness shaping") threshold state (cf.
    # `gptrain_vbmc.m:246-270`): delta below ymax where warping may engage,
    # and the scale of the half-Cauchy prior on the threshold.
    outwarp_delta: Optional[float] = None
    outwarp_thresh_base: Optional[float] = None
    # Warm chain starts (n, Nhyp): when provided, slice chains start at
    # these previous posterior samples instead of MAP+jitter — the burn-in
    # can then be cut to ~thin (in-iteration quick retrains,
    # `activesample_vbmc.m:59-63` options_update analogue).
    chain_starts: Optional[np.ndarray] = None


def get_hpd(X: np.ndarray, y: np.ndarray, frac: float = 0.8):
    """Top-`frac` of points by log-density (cf. `misc/gethpd_vbmc.m`)."""
    n_hpd = max(int(np.ceil(frac * X.shape[0])), 1)
    order = np.argsort(y)[::-1]
    sel = order[:n_hpd]
    return X[sel], y[sel]


def assemble_hyp_prior(cfg: GPConfig, X: np.ndarray, y: np.ndarray,
                       plb_tr: np.ndarray, pub_tr: np.ndarray,
                       opts: TrainOptions) -> HypPrior:
    """Bounds/priors/starting box for all hyperparameters (host-side).

    Mirrors `gptrain_vbmc.m:109-311` (vbmc_gphyp): stats are computed on the
    HPD subset; the length-scale prior comes from the plausible box.
    """
    D = cfg.D
    X_hpd, y_hpd = get_hpd(X, y, opts.hpd_frac)
    width = np.maximum(X_hpd.max(axis=0) - X_hpd.min(axis=0), 1e-10)
    yh = y_hpd if y_hpd.size > 1 else np.array([0.0, 1.0])
    height = max(yh.max() - yh.min(), 1e-10)
    ToL, Big = 1e-6, np.exp(3.0)

    nh = cfg.nhyp
    lb = np.full(nh, -np.inf)
    ub = np.full(nh, np.inf)
    plb = np.full(nh, -np.inf)
    pub = np.full(nh, np.inf)
    x0 = np.full(nh, np.nan)
    mu = np.full(nh, np.nan)
    sigma = np.full(nh, np.nan)
    df = np.full(nh, 3.0)

    # --- covariance: log ell, log sf (cf. gplite_covfun info) ---
    # Iso kernels carry ONE length scale whose stats are dimension means
    # (`gplite_covfun.m:116-123`); ard kernels get per-dimension stats.
    ne = cfg.n_ell
    lw = np.log(width) if ne == D else np.mean(np.log(width))
    lb[:ne] = lw + np.log(ToL)
    ub[:ne] = lw + np.log(10.0)
    plb[:ne] = lw + 0.5 * np.log(ToL)
    pub[:ne] = lw
    lsd = np.log(np.maximum(X_hpd.std(axis=0, ddof=1), 1e-10))
    x0[:ne] = lsd if ne == D else np.mean(lsd)
    i_sf = cfg.idx_log_sf
    lb[i_sf] = np.log(height) + np.log(ToL)
    ub[i_sf] = np.log(height * 10)
    plb[i_sf] = np.log(height) + 0.5 * np.log(ToL)
    pub[i_sf] = np.log(height)
    x0[i_sf] = np.log(max(np.std(yh, ddof=1), 1e-10))

    lplaus = np.log(opts.upper_length_factor * (pub_tr - plb_tr)) \
        if opts.upper_length_factor > 0 else None
    if lplaus is not None:
        ub[:ne] = lplaus if ne == D else np.mean(lplaus)

    # Fixed length-scale prior from the plausible box (gptrain:288-289).
    mult = opts.length_prior_mean_mult
    if mult is None:
        mult = np.sqrt(D / 6.0)
    lprior = np.log(mult * (pub_tr - plb_tr))
    mu[:ne] = lprior if ne == D else np.mean(lprior)
    sigma[:ne] = opts.length_prior_std

    # --- noise (gptrain:143-165, 180) ---
    ninfo = noise_info(cfg, yh)
    sl = cfg.sl_noise
    lb[sl], ub[sl] = ninfo["lb"], ninfo["ub"]
    plb[sl], pub[sl] = ninfo["plb"], ninfo["pub"]
    x0[sl] = ninfo["x0"]
    min_noise = opts.tol_gp_noise
    i_n = cfg.ncov
    if cfg.const_noise == 1:
        if opts.uncertainty_level == 0:
            noisesize = max(opts.noise_size or 0.0, min_noise)
            noisestd = 0.5
        elif opts.uncertainty_level == 1:
            noisesize = min_noise
            noisestd = np.log(10.0)
        else:
            noisesize = min_noise
            noisestd = 0.5
        x0[i_n] = np.log(noisesize)
        mu[i_n] = np.log(noisesize)
        sigma[i_n] = noisestd
        lb[i_n] = np.log(min_noise)
        i_n += 1
    if cfg.user_noise == 2:
        noisemult = max(opts.noise_size or 0.0, min_noise) \
            if opts.noise_size else 1.0
        noisemultstd = np.log(10.0) / 2 if opts.noise_size else np.log(10.0)
        x0[i_n] = np.log(noisemult)
        mu[i_n] = np.log(noisemult)
        sigma[i_n] = noisemultstd
        i_n += 1

    # --- mean (gptrain:182-203) ---
    minfo = mean_info(cfg, X_hpd, yh)
    sl = cfg.sl_mean
    lb[sl], ub[sl] = minfo["lb"], minfo["ub"]
    plb[sl], pub[sl] = minfo["plb"], minfo["pub"]
    x0[sl] = minfo["x0"]
    i_m = cfg.ncov + cfg.nnoise
    if cfg.meanfun in (MEAN_NEGQUAD, MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                       MEAN_NEGQUADSEFIX, MEAN_NEGQUADMIX) \
            and opts.quadratic_mean_bound:
        # gpQuadraticMeanBound applies to every quadratic family the
        # reference trains: meanfuns {4,10,12,14,22} (gptrain_vbmc.m:186-203).
        deltay = max(opts.tol_sd, min(D, yh.max() - yh.min()))
        ub[i_m] = yh.max() + deltay
    elif cfg.meanfun == MEAN_CONST:
        ub[i_m] = yh.min()
    elif cfg.meanfun == MEAN_SE:
        x0[i_m] = y.min()
        ub[i_m] = yh.min()
    if cfg.meanfun == MEAN_NEGQUADSEFIX:
        # Tighter SE-rescale bounds + Student-t priors on alpha_se/h_se
        # (gptrain_vbmc.m:190-193,291-296) — without them h_se roams to 1e4
        # and the fit is far less regularized than the reference.
        i_a, i_h = i_m + D + 1, i_m + D + 2
        ub[i_a] = np.log(1.0)
        lb[i_a] = np.log(1e-3)
        mu[i_a], sigma[i_a] = np.log(0.1), np.log(10.0)
        mu[i_h], sigma[i_h] = np.log(0.1), np.log(100.0)
    elif cfg.meanfun == MEAN_NEGQUADMIX:
        # t-priors on the mixture shape hyps hm/rho/beta
        # (gptrain_vbmc.m:221-230); deltay uses the FULL y range there.
        deltay_all = float(np.asarray(y, float).max()
                           - np.asarray(y, float).min())
        i_hm = i_m + 2 * D + 1
        mu[i_hm], sigma[i_hm] = 0.0, max(0.5 * deltay_all, 1e-3)
        mu[i_hm + 1], sigma[i_hm + 1] = 0.0, 1.0     # log rho
        mu[i_hm + 2], sigma[i_hm + 2] = 0.0, 1.0     # log beta

    # --- output warp (gptrain:246-270) ---
    if cfg.noutwarp > 0:
        from vbmc_tpu.gp.outwarp import outwarp_info
        oinfo = outwarp_info(cfg.outwarp, yh)
        sl = cfg.sl_outwarp
        lb[sl], ub[sl] = oinfo["lb"], oinfo["ub"]
        plb[sl], pub[sl] = oinfo["plb"], oinfo["pub"]
        x0[sl] = oinfo["x0"]
        i_w = cfg.ncov + cfg.nnoise + cfg.nmean
        delta = opts.outwarp_delta if opts.outwarp_delta is not None \
            else 10.0 * D
        base = opts.outwarp_thresh_base if opts.outwarp_thresh_base \
            is not None else 10.0 * D
        y_all = np.asarray(y, float)
        # Threshold: engages at most `delta` below ymax; half-Cauchy prior.
        ub[i_w] = y_all.max() - delta
        lb[i_w] = min(y_all.min(), y_all.max() - 2 * delta)
        plb[i_w] = min(plb[i_w], ub[i_w])
        pub[i_w] = min(pub[i_w], ub[i_w])
        mu[i_w] = y_all.max() - delta
        sigma[i_w] = base
        df[i_w] = 1.0
        if cfg.outwarp in (1, 2):          # negpow / negpowc1: [y0, log k]
            ub[i_w + 1] = np.log(2.0)
            mu[i_w + 1] = 0.0
            sigma[i_w + 1] = np.log(2.0)
        else:                              # negscaledpow: [y0, log a, log k]
            mu[i_w + 1] = 0.0
            sigma[i_w + 1] = np.log(2.0)
            ub[i_w + 2] = 0.0
            mu[i_w + 2] = 0.0
            sigma[i_w + 2] = np.log(2.0)
        x0[sl] = np.minimum(x0[sl], ub[sl] - 1e-6)

    nanmask = np.isnan(x0)
    x0[nanmask] = 0.5 * (plb[nanmask] + pub[nanmask])

    dt = jnp.zeros(0).dtype
    from vbmc_tpu.utils.hostcache import device_put_cached
    arr = lambda v: device_put_cached(v, dtype=dt)
    return HypPrior(mu=arr(mu), sigma=arr(sigma), df=arr(df),
                    lb=arr(lb), ub=arr(ub), plb=arr(plb), pub=arr(pub)), x0


# ----------------------------------------------------------------------
# Jitted pipeline stages (cached per (cfg, shape) key)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def _eval_design(cfg: GPConfig, hyps, prior, X, y, s2, mask):
    def obj(h):
        return (core.neg_log_marginal_likelihood(cfg, h, X, y, s2, mask)
                - core.hyperprior_logpdf(prior, h))
    return jax.vmap(obj)(hyps)


@partial(jax.jit, static_argnames=("cfg", "maxiter"))
def _map_optimize(cfg: GPConfig, x0s, prior, X, y, s2, mask, maxiter: int):
    def obj(h):
        nll = (core.neg_log_marginal_likelihood(cfg, h, X, y, s2, mask)
               - core.hyperprior_logpdf(prior, h))
        return jnp.where(jnp.isfinite(nll), nll, 1e12)

    def run(x0):
        return minimize_lbfgs_bounded(obj, x0, prior.lb, prior.ub,
                                      maxiter=maxiter)

    return jax.vmap(run)(x0s)


@partial(jax.jit, static_argnames=("cfg", "n_keep_max", "warm", "maxiter",
                                   "sampler"))
def _map_sample_assemble(cfg: GPConfig, key, x0s_map, eps_or_cs, widths,
                         prior, X, y, s2, mask, ns, burn, thin,
                         n_keep_max: int, warm: bool, maxiter: int,
                         sampler: str = "slice"):
    """Fused GP-hyperparameter pipeline: MAP polish -> best select -> chain
    starts (jittered around MAP, or warm starts from the previous posterior)
    -> parallel slice chains -> interleave -> padded sample buffer. One
    device program; the caller pulls (hyp_map, samples, buffer) in a single
    transfer and the GP factorization consumes the buffer without any pull.
    ``ns`` is a DEVICE scalar so the Ns schedule (`gptrain_vbmc.m:314-343`)
    never forces a recompile; the chain key is folded from ``key``
    in-trace (no eager split on the host)."""
    return map_sample_assemble_core(cfg, key, x0s_map, eps_or_cs, widths,
                                    prior, X, y, s2, mask, ns, burn, thin,
                                    n_keep_max, warm, maxiter, sampler)


def hyp_sampler_for(cfg: GPConfig, sb: int) -> str:
    """Sampler policy (the reference's covsample switch,
    `get_GPTrainOptions.m:60-100`, redesigned for batches): batched
    complementary-halves ensemble slice when the hyperparameter count is
    large — its per-sweep sequential depth is ~10 batched evaluations
    regardless of nhyp, vs ~6 x nhyp for a coordinate sweep (measured at
    D=10: gp_train 5.5 s/iter coordinate vs the ensemble's batched
    (W/2,N,N) Cholesky steps). Coordinate slice stays the default at small
    nhyp where its fine-grained moves mix better per evaluation."""
    return "ensemble" if (cfg.nhyp > 20 and sb >= 8) else "slice"  # nhyp>20: D>=6 negquad


def map_sample_assemble_core(cfg: GPConfig, key, x0s_map, eps_or_cs, widths,
                             prior, X, y, s2, mask, ns, burn, thin,
                             n_keep_max: int, warm: bool, maxiter: int,
                             sampler: str = "slice"):
    """Traceable body of `_map_sample_assemble` (also inlined by the fused
    per-point quick-update program, `quick_update.py`)."""
    key = jax.random.fold_in(key, 2)
    def obj(h):
        nll = (core.neg_log_marginal_likelihood(cfg, h, X, y, s2, mask)
               - core.hyperprior_logpdf(prior, h))
        return jnp.where(jnp.isfinite(nll), nll, 1e12)

    if maxiter > 0:
        def run_map(x0):
            return minimize_lbfgs_bounded(obj, x0, prior.lb, prior.ub,
                                          maxiter=maxiter)
        hyp_opt, f_opt = jax.vmap(run_map)(x0s_map)
        best = jnp.argmin(jnp.where(jnp.isfinite(f_opt), f_opt, jnp.inf))
        hyp_map = hyp_opt[best]
    else:
        # No MAP polish: still select the best start IN-TRACE (replaces the
        # host-side design-eval ordering — no pre-selection round trip).
        f0 = jax.vmap(obj)(x0s_map)
        hyp_map = x0s_map[jnp.argmin(jnp.where(jnp.isfinite(f0), f0,
                                               jnp.inf))]
    hyp_map = jnp.clip(hyp_map, prior.lb + 1e-12, prior.ub - 1e-12)

    if warm:
        x0s_chain = eps_or_cs            # (C, nh) previous posterior samples
    else:
        # Chain starts scatter by the (possibly rindex-inflated) sampling
        # widths: on unstable runs this is the mode-discovery mechanism
        # (the reference gets the same effect from width-inflated
        # slicesamplebnd brackets, `get_GPTrainOptions.m:42-46`). Chains
        # stranded in garbage regions are rescued by the log-posterior
        # filter on the collected samples below.
        x0s_chain = hyp_map[None, :] + eps_or_cs * (0.1 * widths)[None, :]
    x0s_chain = jnp.clip(x0s_chain, prior.lb + 1e-10, prior.ub - 1e-10)
    x0s_chain = x0s_chain.at[0].set(hyp_map)

    def logpdf(h):
        lp = core.gp_log_posterior(cfg, prior, h, X, y, s2, mask)
        in_bounds = jnp.all((h >= prior.lb) & (h <= prior.ub))
        lp = jnp.where(jnp.isfinite(lp), lp, -jnp.inf)
        return jnp.where(in_bounds, lp, -jnp.inf)

    if sampler == "ensemble":
        # Batched complementary-halves ensemble ('covsample'): eps_or_cs
        # carries one row per BUFFER slot (W = sb walkers); the final
        # walker population IS the sample buffer.
        from vbmc_tpu.samplers.ensemble import ensemble_slice_final
        flat, lp_flat = ensemble_slice_final(
            jax.random.fold_in(key, 3), logpdf, x0s_chain,
            prior.lb, prior.ub, burn + thin)
        sb = flat.shape[0]
    else:
        C = x0s_chain.shape[0]
        keys = jax.random.split(key, C)
        n_keep = jnp.minimum(ns // C + (ns % C > 0), n_keep_max)

        def run(k, x0):
            return slice_sample_chain(k, logpdf, x0, widths, prior.lb,
                                      prior.ub, n_keep, burn, thin,
                                      n_keep_max)

        samples, logps = jax.vmap(run)(keys, x0s_chain)  # (C, keep_max, nh)
        # Interleave chains: sample i of chain c -> position i*C + c.
        flat = jnp.transpose(samples, (1, 0, 2)).reshape(
            -1, samples.shape[-1])
        lp_flat = jnp.transpose(logps, (1, 0)).reshape(-1)
        sb = flat.shape[0]
    sel = jnp.arange(sb)[:, None] < ns
    # Log-posterior gate: with scattered starts and short per-chain burns,
    # a chain can strand in a garbage region and its samples would poison
    # the hyperparameter ensemble (every downstream GP consumer averages
    # over it). Samples more than 50 nats below the best collected sample
    # collapse to the MAP point; genuine secondary modes (within a few
    # nats, e.g. the flat-target negquad-center ambiguity) pass untouched.
    lp_best = jnp.max(jnp.where(sel[:, 0], lp_flat, -jnp.inf))
    good = (lp_flat > lp_best - 50.0)[:, None]
    buf = jnp.where(sel & good, flat, hyp_map[None, :])
    hyp_mask = jnp.arange(sb) < ns
    return buf, hyp_mask, hyp_map, jnp.where(good, flat, hyp_map[None, :])


@partial(jax.jit, static_argnames=("cfg",))
def _build_gp_jit(cfg, X, y, s2, mask, hyps, hyp_mask):
    return build_gp(cfg, X, y, s2, mask, hyps, hyp_mask)


# ----------------------------------------------------------------------
# Top-level training entry point (host-side orchestration)
# ----------------------------------------------------------------------

def train_gp(key, cfg: GPConfig, X: np.ndarray, y: np.ndarray,
             s2: Optional[np.ndarray], plb_tr, pub_tr, opts: TrainOptions,
             hyp0: Optional[np.ndarray] = None,
             host_seed: Optional[int] = None):
    """Fit the GP surrogate; returns (GP, info dict).

    X, y, s2: host arrays of the *real* (unpadded) training set.
    hyp0: optional (n0, Nhyp) warm-start hyperparameter vectors.
    host_seed: seed for the host-side draws (design points, chain-start
    jitter); when None it is derived from ``key`` (one device pull).
    """
    from vbmc_tpu.utils.hostcache import device_put_cached, to_np, register
    dtype = jnp.zeros(0).dtype
    n = X.shape[0]
    nb = bucket_n(n)
    Xp_np = pad_to(np.asarray(X, float), nb)
    yp_np = pad_to(np.asarray(y, float).ravel(), nb)
    s2p_np = (np.zeros(nb) if s2 is None
              else pad_to(np.asarray(s2, float).ravel(), nb))
    mask_np = np.arange(nb) < n
    Xp = device_put_cached(Xp_np, dtype=dtype)
    yp = device_put_cached(yp_np, dtype=dtype)
    s2p = device_put_cached(s2p_np, dtype=dtype)
    mask = device_put_cached(mask_np)

    prior, x0_default = assemble_hyp_prior(cfg, np.asarray(X), np.asarray(y),
                                           np.asarray(plb_tr),
                                           np.asarray(pub_tr), opts)
    nh = cfg.nhyp
    if host_seed is None:
        host_seed = int(np.asarray(
            jax.random.randint(jax.random.fold_in(key, 91), (), 0,
                               2 ** 31 - 1)))
    hrng = np.random.default_rng(host_seed)

    # --- starting points -------------------------------------------------
    starts = [np.asarray(x0_default)[None, :]]
    if hyp0 is not None and hyp0.size and hyp0.shape[-1] == nh:
        starts.append(np.asarray(hyp0, float).reshape(-1, nh))
    starts = np.unique(np.concatenate(starts, axis=0), axis=0)
    lb_np = np.asarray(to_np(prior.lb), float)
    ub_np = np.asarray(to_np(prior.ub), float)
    plb_np = np.where(np.isfinite(np.asarray(to_np(prior.plb), float)),
                      np.asarray(to_np(prior.plb), float), lb_np)
    pub_np = np.where(np.isfinite(np.asarray(to_np(prior.pub), float)),
                      np.asarray(to_np(prior.pub), float), ub_np)
    starts = np.clip(starts, lb_np + 1e-12, ub_np - 1e-12)

    widths_default = np.maximum(pub_np - plb_np, 1e-3)
    if opts.ninit > 0:
        # The design is evaluated in FIXED-SIZE chunks: the reference's cubic
        # 1024->64 ninit schedule (`get_GPTrainOptions:93-100`) would
        # otherwise produce a new shape — and hence a fresh remote XLA
        # compile — every few iterations. All chunks are dispatched before a
        # single host pull collects the results.
        CHUNK = 256
        n_design = CHUNK * max(1, -(-int(opts.ninit) // CHUNK))
        u = hrng.random((n_design, nh))
        design = plb_np + u * (pub_np - plb_np)
        # Warm starts overwrite the head of the design (fixed total size so
        # the vmapped evaluation compiles once per bucket).
        n_s = min(starts.shape[0], n_design // 2)
        design[:n_s] = starts[:n_s]
        from vbmc_tpu.parallel.context import shard_rows
        futs = [_eval_design(cfg, shard_rows(jnp.asarray(
                    design[i:i + CHUNK], dtype=dtype)),
                             prior, Xp, yp, s2p, mask)
                for i in range(0, n_design, CHUNK)]
        nll = np.concatenate(jax.device_get(futs))
        nll = np.where(np.isfinite(nll), nll, np.inf)
        order = np.argsort(nll)
        x0s = design[order[:max(opts.nopts, 1)]]
        top = design[order[:max(3 * opts.nopts, 10)]]
        widths_default = np.maximum(top.std(axis=0, ddof=1), 1e-3)
    else:
        # No init design: pad the start set to a fixed size (repeat last
        # row). ALL padded starts go into the fused program below, which
        # evaluates/optimizes them vmapped and argmin-selects in-trace —
        # no host-side pre-selection round trip.
        n_pad = 8
        while n_pad < starts.shape[0]:
            n_pad *= 2
        starts_p = np.concatenate(
            [starts, np.tile(starts[-1:], (n_pad - starts.shape[0], 1))])
        x0s = starts_p

    # --- MAP optimization + posterior sampling -----------------------------
    # With sampling on, MAP select + chain starts + chains + buffer assembly
    # run as ONE fused device program (no MAP round trip); the single pull
    # below collects everything the host needs. MAP-only keeps the separate
    # pipeline (the chain program is the expensive compile).
    ns = int(opts.ns_samples)
    if opts.ninit > 0:
        if opts.nopts > 0:
            reps = int(np.ceil(opts.nopts / x0s.shape[0]))
            x0s_map = np.tile(x0s, (reps, 1))[:opts.nopts]
            map_iters = opts.lbfgs_iters
        else:
            x0s_map = x0s[:1]
            map_iters = 0
    else:
        x0s_map = x0s
        map_iters = opts.lbfgs_iters if opts.nopts > 0 else 0

    if ns > 0:
        sb = bucket_ns(ns)
        C = min(opts.n_chains, sb)
        while sb % C != 0:
            C -= 1
        keep_max = sb // C

        if opts.widths is not None and opts.widths.size == nh:
            if opts.widths_escalated:
                # rindex-INFLATED widths on unstable runs
                # (`get_GPTrainOptions.m:42-46`: widthmult =
                # max(GPSampleWidths, rindex)) — the reference's
                # mode-hopping defense when the GP hyperparameter posterior
                # is multimodal (e.g. flat targets where the negquad mean
                # center is ill-identified). Cap only by the finite
                # hyperparameter bound range: clipping to the design
                # defaults (as before round 5) neutered the escalation and
                # let chains sit in one nlZ mode, collapsing the
                # between-sample ELBO variance.
                rng_hyp = ub_np - lb_np
                cap = np.where(np.isfinite(rng_hyp), rng_hyp, np.inf)
                widths = np.minimum(np.asarray(opts.widths, float),
                                    np.maximum(cap, widths_default))
            else:
                # Stable run: tight brackets (wide ones cost ~2-3 extra
                # shrinkage N^3 evals per coordinate per sweep).
                widths = np.minimum(np.asarray(opts.widths, float),
                                    widths_default)
        else:
            widths = widths_default
        burn = opts.burnin if opts.burnin is not None else opts.thin * ns
        sampler = hyp_sampler_for(cfg, sb)
        n_rows = sb if sampler == "ensemble" else C
        if (opts.chain_starts is not None and opts.chain_starts.size
                and opts.chain_starts.shape[-1] == nh):
            # Warm starts from a previous hyperparameter posterior: each
            # chain starts at a distinct prior sample (MAP kept as chain 0).
            cs = np.asarray(opts.chain_starts, float).reshape(-1, nh)
            reps_c = int(np.ceil(n_rows / cs.shape[0]))
            eps_or_cs = np.tile(cs, (reps_c, 1))[:n_rows]
            warm = True
        else:
            eps_or_cs = hrng.standard_normal((n_rows, nh))
            warm = False

        buf_dev, hyp_mask_dev, hyp_map_dev, flat_dev = _map_sample_assemble(
            cfg, key, jnp.asarray(x0s_map, dtype=dtype),
            jnp.asarray(eps_or_cs, dtype=dtype),
            jnp.asarray(widths, dtype=dtype), prior, Xp, yp, s2p, mask,
            jnp.asarray(ns), jnp.asarray(max(burn // C, opts.thin)),
            jnp.asarray(opts.thin), keep_max, warm, map_iters,
            sampler=sampler)
        gp = _build_gp_jit(cfg, Xp, yp, s2p, mask, buf_dev, hyp_mask_dev)
        # ONE blocking pull for every host-needed result; register the
        # sample buffer's host mirror so downstream reads stay free.
        hyp_map, hyp_full, buf_host, hyp_mask_host = jax.device_get(
            (hyp_map_dev, flat_dev, buf_dev, hyp_mask_dev))
        register(buf_dev, buf_host)
        register(hyp_mask_dev, hyp_mask_host)
        hyp_map = np.asarray(hyp_map)
        hyp_full = np.asarray(hyp_full)
        hyp_dev, hyp_mask_out = buf_dev, hyp_mask_dev
    else:
        # MAP-only: still pad the sample axis to the smallest S bucket —
        # dropping from S>1 to S=1 mid-run would recompile every downstream
        # kernel (the S axis is a leading dim of all GP posterior arrays).
        if map_iters > 0:
            hyp_opt, f_opt = jax.device_get(
                _map_optimize(cfg, jnp.asarray(x0s_map, dtype=dtype), prior,
                              Xp, yp, s2p, mask, map_iters))
            best = int(np.nanargmin(np.where(np.isfinite(f_opt), f_opt,
                                             np.inf)))
            hyp_map = np.asarray(hyp_opt)[best]
        else:
            hyp_map = x0s_map[0]
        hyp_map = np.clip(hyp_map, lb_np + 1e-12, ub_np - 1e-12)
        sb = bucket_ns(1)
        buf = np.tile(hyp_map[None, :], (sb, 1))
        hyp_mask = np.arange(sb) < 1
        hyp_full = hyp_map[None, :]
        hyp_dev = device_put_cached(buf, dtype=dtype)
        hyp_mask_out = device_put_cached(hyp_mask)
        gp = _build_gp_jit(cfg, Xp, yp, s2p, mask, hyp_dev, hyp_mask_out)

    # The jit re-emits the passthrough arrays as fresh device buffers;
    # restore the input references so their host mirrors stay attached
    # (orchestration re-reads X/y/mask/hyp every iteration — each read
    # would otherwise be a blocking device->host pull).
    gp = gp._replace(X=Xp, y=yp, s2=s2p, mask=mask, hyp=hyp_dev,
                     hyp_mask=hyp_mask_out)
    # Multi-device: shard the hyperparameter-sample axis over the mesh so
    # every downstream ensemble reduction runs as a cross-device psum.
    from vbmc_tpu.parallel.context import shard_gp
    gp = shard_gp(gp)
    info = dict(hyp_map=hyp_map, hyp_full=hyp_full, prior=prior,
                ns_samples=ns, widths_default=widths_default)
    return gp, info
