"""Fused per-point full update for active sampling on noisy targets.

The reference re-trains the GP hyperparameters and re-fits the variational
posterior after EVERY acquired point when near warmup or unstable
(`activesample_vbmc.m:46-76, 429-490`, options_update quick tolerances).
Done naively that is ~7 device programs with ~5 blocking host pulls per
point, each dispatch and pull on the critical path of the noisy-target
loop.

This module fuses the whole update — padded-data GP posterior refresh, MAP
polish + warm-started slice chains (`gplite_train.m:316-330` with the
active-sampling quick tolerances), posterior factorization, and a
jitter-sieve + Adam/L-BFGS VP refit (`vpoptimize_vbmc.m` at Nslowopts=1
with the NSentActive sample counts) — into ONE device program with ZERO
blocking pulls: the returned GP/VP device arrays feed the next proposal
program directly.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.gp import GP, build_gp
from vbmc_tpu.gp.fit import (TrainOptions, assemble_hyp_prior,
                             map_sample_assemble_core)
from vbmc_tpu import elbo as eb
from vbmc_tpu.vp import VariationalPosterior
from vbmc_tpu.utils.math import bucket_n, bucket_ns, pad_to


def _vp_bounds_in_trace(Xp, mask, k_active, tol_length, tol_weight,
                        tol_con_loss, weight_penalty):
    """`elbo.compute_vp_bounds` computed inside the trace (no eager
    dispatches): soft bounds from the training-point hull
    (`vpbounds.m:17-30`)."""
    m = mask.astype(Xp.dtype)
    big = jnp.finfo(Xp.dtype).max
    Xmin = jnp.min(jnp.where(m[:, None] > 0, Xp, big), axis=0)
    Xmax = jnp.max(jnp.where(m[:, None] > 0, Xp, -big), axis=0)
    lnrange = jnp.log(jnp.maximum(Xmax - Xmin, 1e-10))
    return eb.ThetaBounds(
        mu_lb=Xmin, mu_ub=Xmax,
        lnscale_lb=lnrange + math.log(tol_length),
        lnscale_ub=lnrange,
        eta_lb=jnp.asarray(math.log(0.5 * tol_weight), dtype=Xp.dtype),
        eta_ub=jnp.asarray(0.0, dtype=Xp.dtype),
        tol_con=tol_con_loss,
        weight_threshold=jnp.maximum(1.0 / (4.0 * k_active), tol_weight),
        weight_penalty=weight_penalty)


@partial(jax.jit, static_argnames=("cfg", "map_iters", "flags",
                                   "n_jitter", "ns_ent_k", "ns_fine_k",
                                   "ns_fast_k", "adam_iters", "use_midpoint",
                                   "do_gp", "do_vp", "tol_length",
                                   "tol_weight", "tol_con_loss",
                                   "weight_penalty"))
def _quick_full_update(cfg: GPConfig, key, salt, Xp, yp, s2p, mask,
                       prior, hyp_prev, widths, ns, burn, thin,
                       vp: VariationalPosterior, k_active,
                       step_min, step_max, tol_fun, elcbo_beta,
                       map_iters: int, flags: eb.VPFlags,
                       n_jitter: int, ns_ent_k: int, ns_fine_k: int,
                       ns_fast_k: int, adam_iters: int, use_midpoint: bool,
                       do_gp: bool, do_vp: bool,
                       tol_length: float, tol_weight: float,
                       tol_con_loss: float, weight_penalty: float):
    """One fused in-iteration full update. Returns (gp, vp, gls) — all
    device arrays, no host pull required."""
    key = jax.random.fold_in(key, salt)
    k_gp, k_sieve, k_opt = jax.random.split(key, 3)
    dtype = Xp.dtype

    # ---- GP: warm-started quick retrain -> posterior factorization -------
    if do_gp:
        # Chains start at the previous posterior samples (the posterior
        # moved by ONE datapoint); short burn-in, short MAP polish — the
        # reference's looser in-iteration GP tolerances
        # (`activesample_vbmc.m:59-63`).
        sb = hyp_prev.shape[0]
        C = max(min(8, sb), 1)
        while sb % C != 0:
            C -= 1
        from vbmc_tpu.gp.fit import hyp_sampler_for
        sampler = hyp_sampler_for(cfg, sb)
        chain_starts = hyp_prev if sampler == "ensemble" else hyp_prev[:C]
        buf, hyp_mask, hyp_map, _ = map_sample_assemble_core(
            cfg, k_gp, hyp_prev[:1], chain_starts, widths, prior,
            Xp, yp, s2p, mask, ns, burn, thin, sb // C, True, map_iters,
            sampler=sampler)
    else:
        buf, hyp_mask = hyp_prev, jnp.arange(hyp_prev.shape[0]) < ns
    gp = build_gp(cfg, Xp, yp, s2p, mask, buf, hyp_mask)

    hm = gp.hyp_mask.astype(dtype)
    gls = jnp.exp(jnp.sum(gp.hyp[:, :cfg.D] * hm[:, None], axis=0)
                  / jnp.maximum(jnp.sum(hm), 1.0))

    if not do_vp:
        return gp, vp, gls

    # ---- VP: jitter sieve + one slow optimization + precise eval ---------
    # Candidate 0 is the current VP; the rest are vbinit type-1 jitters
    # (`vbinit_vbmc.m:111-125`) generated in-trace.
    bnd = _vp_bounds_in_trace(Xp, mask, k_active.astype(dtype), tol_length,
                              tol_weight, tol_con_loss, weight_penalty)

    K_max, D = vp.mu.shape
    km = vp.kmask.astype(dtype)

    def jitter(i):
        kj = jax.random.fold_in(k_sieve, i)
        k1, k2, k3, k4 = jax.random.split(kj, 4)
        scale = jnp.where(i == 0, 0.0, 1.0).astype(dtype)
        mu = vp.mu + scale * vp.sigma[:, None] * vp.lam[None, :] * \
            jax.random.normal(k1, (K_max, D), dtype=dtype)
        sigma = vp.sigma * jnp.exp(
            0.2 * scale * jax.random.normal(k2, (K_max,), dtype=dtype))
        lam = vp.lam * jnp.exp(
            0.2 * scale * jax.random.normal(k3, (D,), dtype=dtype))
        if flags.opt_weights:
            w = vp.w * jnp.exp(
                0.2 * scale * jax.random.normal(k4, (K_max,), dtype=dtype))
            w = w * km
            w = w / jnp.maximum(jnp.sum(w), 1e-30)
        else:
            w = vp.w
        eta = jnp.where(vp.kmask, jnp.log(jnp.maximum(w, 1e-30)), -40.0)
        return eb.pack_theta(flags, mu, sigma, lam, eta)

    thetas = jax.vmap(jitter)(jnp.arange(n_jitter))

    def cheap(theta, i):
        # Sieve entropy sample count (NSentFastActive; default 0 => the
        # deterministic entropy lower bound, `vpsieve_vbmc.m:23-33`).
        F, _ = eb.negelcbo(cfg, theta, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                           vp.kmask, flags, 0.0, ns_fast_k, 0,
                           jax.random.fold_in(k_sieve, 100 + i),
                           bnd=bnd, use_bounds=True)
        return F

    Fs = jax.vmap(cheap)(thetas, jnp.arange(n_jitter))
    theta0 = thetas[jnp.argmin(jnp.where(jnp.isfinite(Fs), Fs, jnp.inf))]

    tmpl = (vp.mu, vp.sigma, vp.lam, vp.w, vp.kmask)

    if ns_ent_k > 0:
        from vbmc_tpu.optim import fminadam

        def f_vg(th, kk):
            def f(t):
                F, _ = eb.negelcbo(cfg, t, gp, *tmpl, flags, elcbo_beta,
                                   ns_ent_k, 0, kk, bnd=bnd, use_bounds=True)
                return F
            return jax.value_and_grad(f)(th)

        res = fminadam(f_vg, theta0, tol_fun=tol_fun, maxiter=adam_iters,
                       step_min=step_min, step_max=step_max, key=k_opt)
        if use_midpoint:
            # ELCBO-midpoint selection (`vpoptimize_vbmc.m:103-136`).
            T = res.f_trace.shape[0]
            masked = jnp.where(jnp.arange(T) < res.n_iters, res.f_trace,
                               jnp.inf)
            cands = jnp.stack([res.x_trace[jnp.argmin(masked)], res.x])
        else:
            cands = res.x[None, :]
    else:
        from vbmc_tpu.optim import minimize_lbfgs_bounded

        def obj(t):
            F, _ = eb.negelcbo(cfg, t, gp, *tmpl, flags, elcbo_beta, 0, 0,
                               k_opt, bnd=bnd, use_bounds=True)
            return F
        lb = jnp.full(theta0.shape, -jnp.inf, dtype=dtype)
        ub = jnp.full(theta0.shape, jnp.inf, dtype=dtype)
        x_opt, _ = minimize_lbfgs_bounded(obj, theta0, lb, ub,
                                          maxiter=adam_iters)
        cands = x_opt[None, :]

    def full_eval(th, i):
        return eb.elbo_stats(cfg, th, gp, *tmpl, flags, ns_fine_k, 1,
                             jax.random.fold_in(k_opt, 7 + i))

    sts = jax.vmap(full_eval)(cands, jnp.arange(cands.shape[0]))
    # Pick by ELCBO, as `vpoptimize_vbmc.m:160-190` (beta = ELCBOWeight).
    score = (-sts["elbo"]
             + elcbo_beta * jnp.sqrt(jnp.maximum(sts["varF"], 0.0)))
    best = jnp.argmin(jnp.where(jnp.isfinite(score), score, jnp.inf))
    mu_new = sts["mu"][best]
    sg_new = sts["sigma"][best]
    lam_new = sts["lam"][best]
    w_new = sts["w"][best] * km
    w_new = w_new / jnp.maximum(jnp.sum(w_new), 1e-30)
    eta_new = jnp.where(vp.kmask, jnp.log(jnp.maximum(w_new, 1e-30)), -40.0)
    vp_new = vp._replace(mu=mu_new, sigma=sg_new, lam=lam_new, w=w_new,
                         eta=eta_new)
    return gp, vp_new, gls


class QuickUpdater:
    """Host wrapper: assembles per-point inputs (padded training data,
    hyperprior, sampler schedule) and dispatches the fused update program.

    Built once per `active_sample` call by the orchestrator; invoked after
    each acquired point (except the last). The dispatch is asynchronous —
    callers never block on it."""

    def __init__(self, cfg: GPConfig, options, topts: TrainOptions,
                 plb_t, pub_t, *, warmup: bool, entropy_switch: bool,
                 K: int, do_gp: bool, do_vp: bool, noise_shaping=None):
        self.cfg = cfg
        self.options = options
        self.topts = topts
        self.plb_t = np.asarray(plb_t)
        self.pub_t = np.asarray(pub_t)
        self.noise_shaping = noise_shaping
        self.do_gp = do_gp
        self.do_vp = do_vp
        self.K = K

        o = options
        from vbmc_tpu.vpoptim import _bucket_ent
        opt_weights = (not warmup) and o.variable_weights
        self.flags = eb.VPFlags(opt_mu=(o.variable_means if not warmup
                                        else True),
                                opt_sigma=True, opt_lambda=True,
                                opt_weights=opt_weights)
        ns_ent_k = _bucket_ent(int(math.ceil(
            o.evalopt("ns_ent_active", K) / K)))
        if entropy_switch or K == 1:
            ns_ent_k = 0
        self.ns_ent_k = ns_ent_k
        ns_fine_k = _bucket_ent(int(math.ceil(
            o.evalopt("ns_ent_fine_active", K) / K)))
        if entropy_switch:
            ns_fine_k = 0
        self.ns_fine_k = ns_fine_k
        ns_fast_k = _bucket_ent(int(math.ceil(
            o.evalopt("ns_ent_fast_active", K) / K)))
        if entropy_switch or K == 1:
            ns_fast_k = 0
        self.ns_fast_k = ns_fast_k
        self.adam_iters = (int(min(o.max_iter_stochastic, 10000))
                           if ns_ent_k > 0 else o.lbfgs_iters)
        self.use_midpoint = bool(o.elcbo_midpoint) and ns_ent_k > 0
        step_min = min(o.sgd_step_size, 0.001)
        if warmup or not opt_weights:
            step_max = min(0.1, o.sgd_step_size * 10)
        else:
            step_max = min(0.1, o.sgd_step_size)
        self.step_min = step_min
        self.step_max = max(step_min, step_max)
        self.salt = 0

    def __call__(self, key, logger, gp: GP, vp: VariationalPosterior):
        from vbmc_tpu.utils.hostcache import device_put_cached
        from vbmc_tpu.parallel.context import shard_gp

        cfg, topts, o = self.cfg, self.topts, self.options
        dtype = gp.X.dtype
        X, y, s2 = logger.training_data(
            noise_shaping=self.noise_shaping,
            options=o if self.noise_shaping is not None else None)
        n = X.shape[0]
        nb = bucket_n(n)
        Xp = device_put_cached(pad_to(X, nb), dtype=dtype)
        yp = device_put_cached(pad_to(y, nb), dtype=dtype)
        s2p = (device_put_cached(np.zeros(nb), dtype=dtype) if s2 is None
               else device_put_cached(pad_to(s2, nb), dtype=dtype))
        mask = device_put_cached(np.arange(nb) < n)

        prior, _ = assemble_hyp_prior(cfg, X, y, self.plb_t, self.pub_t,
                                      topts)
        ns = max(int(topts.ns_samples), 1)
        sb = bucket_ns(ns)
        # Sampler widths from the plausible hyperparameter box (the quick
        # path skips the init design, mirroring train_gp's ninit=0 branch),
        # capped by the running hyp-covariance widths when available.
        from vbmc_tpu.utils.hostcache import to_np as _tn
        lb_np = np.asarray(_tn(prior.lb), float)
        ub_np = np.asarray(_tn(prior.ub), float)
        plb_np = np.where(np.isfinite(np.asarray(_tn(prior.plb), float)),
                          np.asarray(_tn(prior.plb), float), lb_np)
        pub_np = np.where(np.isfinite(np.asarray(_tn(prior.pub), float)),
                          np.asarray(_tn(prior.pub), float), ub_np)
        widths_default = np.maximum(pub_np - plb_np, 1e-3)
        if topts.widths is not None and \
                np.asarray(topts.widths).size == cfg.nhyp:
            if topts.widths_escalated:
                # Keep the rindex inflation (see gp/fit.py): cap by the
                # finite bound range, not the plausible-box defaults.
                rng_hyp = ub_np - lb_np
                cap = np.where(np.isfinite(rng_hyp), rng_hyp, np.inf)
                widths = np.minimum(np.asarray(topts.widths, float),
                                    np.maximum(cap, widths_default))
            else:
                widths = np.minimum(np.asarray(topts.widths, float),
                                    widths_default)
        else:
            widths = widths_default
        # Short per-chain burn-in (quick-retrain schedule, burnin=thin*3
        # split over the chains — same as train_gp's chain split).
        C = max(min(8, sb), 1)
        while sb % C != 0:
            C -= 1
        burn = max((topts.thin * 3) // C, topts.thin)

        # Previous samples live on device already (S_max == sb when the
        # bucket is unchanged; rebucket via host fallback otherwise).
        hyp_prev = gp.hyp
        if hyp_prev.shape[0] != sb:
            from vbmc_tpu.utils.hostcache import to_np
            hp = np.asarray(to_np(gp.hyp), float)
            reps = int(np.ceil(sb / hp.shape[0]))
            hyp_prev = jnp.asarray(np.tile(hp, (reps, 1))[:sb], dtype=dtype)

        self.salt += 1
        gp_new, vp_new, gls = _quick_full_update(
            cfg, key, jnp.asarray(self.salt, dtype=jnp.int32),
            Xp, yp, s2p, mask, prior, hyp_prev,
            jnp.asarray(widths, dtype=dtype), jnp.asarray(ns),
            jnp.asarray(burn), jnp.asarray(topts.thin), vp,
            jnp.asarray(self.K, dtype=dtype),
            jnp.asarray(self.step_min, dtype=dtype),
            jnp.asarray(self.step_max, dtype=dtype),
            jnp.asarray(o.tol_fun_stochastic, dtype=dtype),
            jnp.asarray(o.elcbo_weight, dtype=dtype),
            map_iters=min(topts.lbfgs_iters, 30) if self.do_gp else 0,
            flags=self.flags, n_jitter=4, ns_ent_k=self.ns_ent_k,
            ns_fine_k=self.ns_fine_k, ns_fast_k=self.ns_fast_k,
            adam_iters=self.adam_iters,
            use_midpoint=self.use_midpoint, do_gp=self.do_gp,
            do_vp=self.do_vp, tol_length=float(o.tol_length),
            tol_weight=float(o.tol_weight),
            tol_con_loss=float(o.tol_con_loss),
            weight_penalty=float(o.weight_penalty))
        # Restore passthrough references so host mirrors stay attached.
        gp_new = gp_new._replace(X=Xp, y=yp, s2=s2p, mask=mask)
        return shard_gp(gp_new), vp_new, gls
