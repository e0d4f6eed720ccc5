"""The VBMC orchestrator: the full inference loop
(cf. `vbmc.m:506-882` and the private controllers).

Orchestration (state machine, warmup, termination, warp-undo transactions)
stays in Python; every numeric path — GP fits, acquisition sweeps,
variational optimization, posterior queries — is a jitted, batched, masked
kernel from the other modules.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.options import VBMCOptions, ResolvedOptions
from vbmc_tpu.transforms import (create_trinfo, direct, direct_np,
                                 LOGIT, PROBIT, STUDENT4)
from vbmc_tpu.utils.hostcache import to_np
from vbmc_tpu.function_logger import FunctionLogger
from vbmc_tpu.gp.config import (GPConfig, MEAN_ZERO, MEAN_CONST,
                                MEAN_NEGQUAD, MEAN_SE, MEAN_NEGQUADSE,
                                MEAN_NEGQUADONLY, MEAN_NEGQUADLINONLY,
                                MEAN_NEGQUADFIXISO, MEAN_NEGQUADFIX,
                                MEAN_NEGQUADSEFIX, MEAN_NEGQUADFIXONLY,
                                MEAN_NEGQUADMIX, FIXED_CENTER_MEANFUNS)
from vbmc_tpu.gp.fit import train_gp, TrainOptions, get_hpd
from vbmc_tpu.gp.predict import gp_predict
from vbmc_tpu.vp import (VariationalPosterior, make_vp, vp_moments, vp_kldiv,
                         is_valid_vp, vp_rnd)
from vbmc_tpu.vpoptim import vpoptimize
from vbmc_tpu.active_sample import (initial_design, active_sample,
                                    SearchBounds, gp_reupdate)
from vbmc_tpu import state as st
from vbmc_tpu.utils.math import bucket_k, mvn_kl

_MEANFUN_IDS = {"zero": MEAN_ZERO, "const": MEAN_CONST,
                "negquad": MEAN_NEGQUAD, "se": MEAN_SE,
                "negquadse": MEAN_NEGQUADSE,
                "negquadonly": MEAN_NEGQUADONLY,
                "negquadlinonly": MEAN_NEGQUADLINONLY,
                "negquadfixiso": MEAN_NEGQUADFIXISO,
                "negquadfix": MEAN_NEGQUADFIX,
                "negquadsefix": MEAN_NEGQUADSEFIX,
                "negquadfixonly": MEAN_NEGQUADFIXONLY,
                "negquadmix": MEAN_NEGQUADMIX}
_TRANSFORM_IDS = {"logit": LOGIT, "probit": PROBIT, "norminv": PROBIT,
                  "student4": STUDENT4}
_OUTWARP_IDS = {"negpow": 1, "negpowc1": 2, "negscaledpow": 3}


@dataclasses.dataclass
class VBMCResult:
    vp: VariationalPosterior
    elbo: float
    elbo_sd: float
    exitflag: int
    message: str
    stats: st.Stats
    optim_state: st.OptimState
    logger: FunctionLogger
    vp_train: VariationalPosterior
    func_count: int
    iterations: int
    convergence_status: str
    idx_best: int
    timers: dict
    # Algorithmic overhead: total runtime / total target-eval time - 1
    # (`vbmc.m:937-939`).
    overhead: float = float("nan")


def bounds_check(x0, lb, ub, plb, pub, D):
    """Validate/repair bounds (cf. `misc/boundscheck_vbmc.m:12-142`):
    error on x0 outside the hard bounds, nudge on-bound x0 strictly inside
    the effective bounds, expand PLB/PUB to cover outlying x0."""
    import warnings

    def broadcast(v, default):
        if v is None:
            return np.full(D, default, dtype=float)
        v = np.asarray(v, dtype=float).ravel()
        if v.size == 1:
            return np.full(D, float(v[0]))
        return v.copy()

    lb = broadcast(lb, -np.inf)
    ub = broadcast(ub, np.inf)
    x0 = np.atleast_2d(np.asarray(x0, float)) if x0 is not None else None

    if plb is None or pub is None:
        if x0 is not None and x0.shape[0] > 1:
            plb_i = np.min(x0, axis=0) if plb is None else broadcast(plb, np.nan)
            pub_i = np.max(x0, axis=0) if pub is None else broadcast(pub, np.nan)
            width = pub_i - plb_i
            plb_i = plb_i - 0.1 * width
            pub_i = pub_i + 0.1 * width
            plb = np.maximum(lb, plb_i)
            pub = np.minimum(ub, pub_i)
        else:
            if plb is None:
                plb = lb.copy()
            if pub is None:
                pub = ub.copy()
    plb = broadcast(plb, np.nan)
    pub = broadcast(pub, np.nan)

    half = (np.isfinite(lb) ^ np.isfinite(ub))
    if np.any(half):
        raise ValueError(
            "Variables bounded only on one side are not supported; use a "
            "transformed parameterization or provide both bounds.")

    # x0 strictly inside the hard bounds is a hard error
    # (`boundscheck_vbmc.m:76-79`).
    if x0 is not None and (np.any(x0 < lb[None, :]) or
                           np.any(x0 > ub[None, :])):
        raise ValueError(
            "The starting points x0 are not inside the provided hard "
            "bounds LB and UB.")

    # Effective bounds slightly inside the hard bounds (`:82-92`); bounds
    # near zero use the absolute scale factor.
    rng_b = ub - lb
    rng_b = np.where(np.isinf(rng_b), 1e3, rng_b)
    sf = 1e-3
    lb_eff = np.where(np.abs(lb) <= np.finfo(float).tiny, sf * rng_b,
                      lb + sf * rng_b)
    ub_eff = np.where(np.abs(ub) <= np.finfo(float).tiny, -sf * rng_b,
                      ub - sf * rng_b)
    lb_eff = np.where(np.isinf(lb), lb, lb_eff)
    ub_eff = np.where(np.isinf(ub), ub, ub_eff)
    if np.any(lb_eff >= ub_eff):
        raise ValueError(
            "Hard bounds LB and UB are numerically too close; make them "
            "more separate.")

    # x0 on (or numerically too close to) the hard bounds: move inside
    # with a warning (`:98-103`).
    if x0 is not None and (np.any(x0 <= lb_eff[None, :]) or
                           np.any(x0 >= ub_eff[None, :])):
        warnings.warn(
            "The starting points x0 are on or numerically too close to the "
            "hard bounds LB and UB; moving the initial points inside.")
        x0 = np.clip(x0, lb_eff, ub_eff)

    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")

    # Plausible bounds reasonably separated from hard bounds (`:115-119`).
    if np.any(plb <= lb_eff) or np.any(pub >= ub_eff):
        warnings.warn(
            "Hard and plausible bounds should not be too close; moving "
            "the plausible bounds.")
        plb = np.maximum(plb, lb_eff)
        pub = np.minimum(pub, ub_eff)

    # Expand plausible bounds to cover outlying x0 (`:121-127`).
    if x0 is not None and (np.any(x0 <= plb[None, :]) or
                           np.any(x0 >= pub[None, :])):
        warnings.warn(
            "The starting points x0 are not inside the provided plausible "
            "bounds PLB and PUB; expanding the plausible bounds.")
        plb = np.minimum(plb, np.min(x0, axis=0))
        pub = np.maximum(pub, np.max(x0, axis=0))

    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")
    return x0, lb, ub, plb, pub


def _gp_train_options(state: st.OptimState, stats: st.Stats,
                      options: ResolvedOptions, logger: FunctionLogger,
                      uncertainty_level: int) -> TrainOptions:
    """GP training policy per iteration (cf. `misc/get_GPTrainOptions.m` and
    the Ns schedule in `gptrain_vbmc.m:314-343`)."""
    n = logger.n_train
    neff = logger.neff
    it = len(stats) + 1

    # Hyperparameter sample count schedule.
    if state.stop_sampling == 0:
        ns = int(round(options.ns_gp_max / math.sqrt(max(n, 1))))
        if state.warmup:
            ns = min(ns, options.ns_gp_max_warmup)
        else:
            if math.isfinite(options.ns_gp_max_main):
                ns = min(ns, int(options.ns_gp_max_main))
        if n >= options.stable_gp_sampling:
            state.stop_sampling = n
        if state.vp_K >= options.stable_gp_vp_k:
            state.stop_sampling = n
    if state.stop_sampling > 0:
        ns = options.stable_gp_samples

    # Cubic Ninit schedule 1024 -> 64 (`get_GPTrainOptions:93-100`).
    a = -(options.gp_train_n_init - options.gp_train_n_init_final)
    b, c, d = -3 * a, 3 * a, options.gp_train_n_init
    x = (neff - options.fun_eval_start) / \
        (min(options.max_fun_evals, 1e3) - options.fun_eval_start)
    n_init = max(int(round(a * x ** 3 + b * x ** 2 + c * x + d)), 0)

    rindex_prev = stats.last.rindex if len(stats) else math.inf
    thin = options.gp_sample_thin
    if state.recompute_var_post:
        burnin = thin * ns
        nopts = 1 if ns > 0 else 2
    else:
        burnin = thin * 3
        if rindex_prev < options.gp_retrain_threshold:
            n_init = 0
            nopts = 0 if ns > 0 else 1
        else:
            burnin = thin * ns
            nopts = 1 if ns > 0 else 2

    # Sampler widths from the running weighted hyp covariance.
    widths = None
    escalated = False
    if options.gp_sample_widths > 0 and state.hyp_runcov is not None:
        widthmult = max(options.gp_sample_widths,
                        rindex_prev if math.isfinite(rindex_prev) else
                        options.gp_sample_widths)
        widths = np.maximum(np.sqrt(np.diag(state.hyp_runcov)), 1e-3) * widthmult
        # Escalated = rindex exceeds the base multiplier: only then do the
        # inflated widths bypass the design-derived cap in train_gp (mode
        # hopping on unstable runs, `get_GPTrainOptions.m:42-46`); stable
        # runs keep the tight widths — wide brackets cost ~2-3 extra
        # shrinkage N^3 evals per coordinate per sweep (measured: D=10
        # steady-state gp_train 4-5 s/iter vs ~1 s capped).
        escalated = bool(widthmult > options.gp_sample_widths)

    noise_size = options.noise_size
    return TrainOptions(
        ns_samples=ns, ninit=n_init, nopts=max(nopts, 0 if ns > 0 else 1),
        thin=thin, burnin=burnin, n_chains=options.n_gp_chains,
        widths=widths, widths_escalated=escalated,
        lbfgs_iters=options.lbfgs_iters,
        hpd_frac=options.hpd_frac, tol_gp_noise=options.tol_gp_noise,
        noise_size=noise_size,
        length_prior_mean_mult=options.evalopt("gp_length_prior_mean",
                                               options.D),
        length_prior_std=options.gp_length_prior_std,
        quadratic_mean_bound=options.gp_quadratic_mean_bound,
        tol_sd=options.tol_sd, uncertainty_level=uncertainty_level,
        upper_length_factor=options.upper_gp_length_factor,
        outwarp_delta=state.outwarp_delta,
        outwarp_thresh_base=options.out_warp_thresh_base)


def _update_hyp_runcov(state: st.OptimState, hyp_full: np.ndarray,
                       options: ResolvedOptions):
    """Running average of hyperparameter covariance
    (`gptrain_vbmc.m:82-94`)."""
    if hyp_full is None or hyp_full.shape[0] <= 1:
        state.hyp_runcov = None
        return
    hypcov = np.cov(hyp_full.T)
    if state.hyp_runcov is None or options.hyp_run_weight == 0:
        state.hyp_runcov = hypcov
    else:
        w = options.hyp_run_weight ** options.fun_evals_per_iter
        state.hyp_runcov = (1 - w) * hypcov + w * state.hyp_runcov


def _recenter_cfg(cfg: GPConfig, X_tr: np.ndarray,
                  y_tr: np.ndarray) -> GPConfig:
    """Refresh the fixed mean-function center to the current incumbent for
    the FIXED_CENTER_MEANFUNS families (the reference recomputes
    `meanfun_extras` = X[argmax y] at every `gplite_train`,
    `gplite_meanfun.m:334-341`). The center is static GP config here, so a
    *moved* incumbent compiles fresh kernel variants — cheap on CPU, and
    these families are analysis configs, not the production path
    (use the default 'negquad' there)."""
    if cfg.meanfun not in FIXED_CENTER_MEANFUNS:
        return cfg
    from vbmc_tpu.gp.means import fix_center_from_data
    center = fix_center_from_data(X_tr, y_tr)
    if center == cfg.fix_center:
        return cfg
    return dataclasses.replace(cfg, fix_center=center)


def _estimate_sn2hpd(cfg: GPConfig, gp, logger, sn2: np.ndarray) -> float:
    """GP noise around the top HPD region (`gptrain_vbmc.m:347-377`).
    ``sn2``: host copy of gp.sn2 (pulled in the finalize batch)."""
    X, y, _ = logger.training_data()
    n_hpd = max(int(math.ceil(0.2 * X.shape[0])), 1)
    sn2 = np.asarray(sn2)                      # (S, N_max)
    m = np.asarray(to_np(gp.hyp_mask), float)
    sn2_mean = (sn2 * m[:, None]).sum(0) / max(m.sum(), 1.0)
    sel = np.where(np.asarray(to_np(gp.mask), bool))[0]
    if sel.size == 0:
        return float("inf")
    vals = sn2_mean[sel]
    order_idx = np.argsort(np.asarray(to_np(gp.y))[sel])[::-1][:n_hpd]
    return float(np.median(vals[order_idx]))


def _predict_padded_dev(cfg, gp, X: np.ndarray):
    """GP predictive summary at host points as LAZY PADDED device arrays
    plus per-chunk true lengths; callers batch the blocking pull with other
    results and assemble with `_assemble_padded`. The truncation happens
    host-side AFTER the pull: slicing a device array by the (per-iteration
    growing) true length would compile a fresh XLA slice per length.
    Inputs are padded to a bucket so the jitted kernel compiles a bounded
    number of variants; point sets larger than the top bucket are processed
    in chunks."""
    from vbmc_tpu.gp.predict import gp_predict_jit
    from vbmc_tpu.utils.math import bucket_n, pad_to, N_BUCKETS

    X = np.asarray(X, float)
    n = X.shape[0]
    top = N_BUCKETS[-1]
    fb, vt, ns = [], [], []
    for i in range(0, max(n, 1), top):
        chunk = X[i:i + top]
        nb = bucket_n(chunk.shape[0])
        Xp = jnp.asarray(pad_to(chunk, nb), dtype=gp.X.dtype)
        fbar, vtot, _, _ = gp_predict_jit(cfg, gp, Xp)
        fb.append(fbar)
        vt.append(vtot)
        ns.append(chunk.shape[0])
    return (fb, vt), ns


def _assemble_padded(pulled, ns):
    """Host-side truncate-and-concat of pulled padded chunks."""
    return np.concatenate([np.asarray(a)[:k] for a, k in zip(pulled, ns)])


def _predict_padded(cfg, gp, X: np.ndarray):
    """As `_predict_padded_dev` with an immediate (single) blocking pull."""
    (fb, vt), ns = _predict_padded_dev(cfg, gp, X)
    fb_h, vt_h = jax.device_get((fb, vt))
    return _assemble_padded(fb_h, ns), _assemble_padded(vt_h, ns)


def _recompute_lcbmax(cfg, gp, logger, stats: st.Stats, options) -> np.ndarray:
    """Recompute the historical max-LCB trace using the *current* GP
    (cf. `vbmc.m:816`, recompute_lcbmax)."""
    n = logger.Xn
    X = logger.X[:n]
    fbar, vtot = _predict_padded(cfg, gp, X)
    lcb = fbar - options.elcbo_impro_weight * np.sqrt(np.maximum(vtot, 0.0))
    active = logger.X_flag[:n]
    lcb = np.where(active, lcb, -np.inf)
    out = np.empty(len(stats))
    for i, itstat in enumerate(stats.iterations):
        upto = min(int(itstat.func_count), n)
        out[i] = np.max(lcb[:upto]) if upto > 0 else -np.inf
    return out


def vbmc(fun: Callable, x0=None, lb=None, ub=None, plb=None, pub=None,
         options: Optional[VBMCOptions] = None) -> VBMCResult:
    """Run full VBMC inference on a black-box log-joint ``fun``.

    Mirrors the reference public API `vbmc.m:1-155`: returns a variational
    posterior, the ELBO and its uncertainty, plus diagnostics.
    """
    t0 = time.monotonic()
    _configure_numerics()
    if options is None:
        options = VBMCOptions()

    # Warm start from a previous variational posterior.
    x0_from_vp = None
    if is_valid_vp(x0):
        vp0_init = x0
        key_init = jax.random.PRNGKey(options.seed + 77)
        Xvp = np.asarray(vp_rnd(vp0_init, key_init, 100, orig_flag=True))
        x0 = Xvp[:1]
        if plb is None or pub is None:
            plb = np.quantile(Xvp, 0.05, axis=0)
            pub = np.quantile(Xvp, 0.95, axis=0)
        x0_from_vp = Xvp

    if x0 is not None:
        x0 = np.atleast_2d(np.asarray(x0, float))
        D = x0.shape[1]
    elif plb is not None:
        D = np.asarray(plb).ravel().shape[0]
        x0 = None
    else:
        raise ValueError("Provide x0, or plausible bounds PLB and PUB.")

    opt = options.resolve(D)
    # Validate enum-like options up front with clear errors (the reference's
    # unsupported gplite families fail with a named error,
    # `gplite_meanfun.m:112-117`; see PARITY.md §2.5 for the supported set).
    if opt.gp_mean_fun not in _MEANFUN_IDS:
        raise ValueError(
            f"gp_mean_fun={opt.gp_mean_fun!r} is not supported; choose one "
            f"of {sorted(_MEANFUN_IDS)}.")
    if opt.bounded_transform not in _TRANSFORM_IDS:
        raise ValueError(
            f"bounded_transform={opt.bounded_transform!r} is not supported; "
            f"choose one of {sorted(_TRANSFORM_IDS)}.")
    if opt.fitness_shaping and opt.gp_out_warp_fun not in _OUTWARP_IDS:
        raise ValueError(
            f"gp_out_warp_fun={opt.gp_out_warp_fun!r} is not supported; "
            f"choose one of {sorted(_OUTWARP_IDS)}.")
    try:
        for a in (opt.search_acq_fcn or ()):
            _canonical_acq(a)
    except KeyError as e:
        raise ValueError(
            f"search_acq_fcn entry {e.args[0]!r} is not a known acquisition "
            f"function (known: prospective, prospective_sn2, "
            f"prospective_log, us, eig, viqr, imiqr).") from None
    x0, lb, ub, plb, pub = bounds_check(x0, lb, ub, plb, pub, D)
    if x0 is None or not np.all(np.isfinite(x0)):
        x0 = 0.5 * (plb + pub)[None, :]

    if x0_from_vp is not None:
        extra = np.clip(x0_from_vp[1:opt.fun_eval_start],
                        np.where(np.isfinite(lb), lb, -np.inf),
                        np.where(np.isfinite(ub), ub, np.inf))
        x0 = np.concatenate([x0, extra], axis=0)

    # Transform setup.
    trinfo = create_trinfo(lb, ub, plb, pub,
                           bounded_type=_TRANSFORM_IDS[opt.bounded_transform])
    plb_t = direct_np(trinfo, plb[None, :])[0]
    pub_t = direct_np(trinfo, pub[None, :])[0]
    lb_t = direct_np(trinfo, lb[None, :])[0]
    ub_t = direct_np(trinfo, ub[None, :])[0]

    # GP smoothing bandwidth (`setupvars_vbmc.m:247`: delta in units of the
    # plausible box). Applied on the acquisition path (acqwrapper parity);
    # the reference's gplogjoint smoothing is intentionally not carried over
    # (its own comments flag that math as doubtful, `gplogjoint.m:176,193`).
    opt.delta_smoothing = (opt.bandwidth * (pub_t - plb_t)
                           if opt.bandwidth > 0 else None)

    uncertainty_level = (2 if opt.specify_target_noise
                         else (1 if opt.uncertainty_handling else 0))
    logger = FunctionLogger(fun, D, trinfo,
                            uncertainty_level=uncertainty_level,
                            cache_size=opt.cache_size,
                            temperature=opt.temperature)
    cfg = GPConfig(
        D=D, meanfun=_MEANFUN_IDS[opt.gp_mean_fun],
        const_noise=1,
        user_noise={0: 0, 1: 2, 2: 1}[uncertainty_level]
        if not opt.noise_shaping else max(
            {0: 0, 1: 2, 2: 1}[uncertainty_level], 1),
        output_noise=0,
        intmean=int(opt.gp_int_mean_fun),
        outwarp=_OUTWARP_IDS[opt.gp_out_warp_fun]
        if opt.fitness_shaping else 0)

    # Initial variational posterior: K_warmup comps at x0 (+tiny jitter).
    rng = np.random.default_rng(opt.seed)
    K = opt.k_warmup
    u0 = direct_np(trinfo, x0[:1])[0]
    mu_init = np.tile(u0, (K, 1)) + 1e-6 * rng.standard_normal((K, D))
    vp = make_vp(trinfo, mu_init, sigma=1e-3, lam=np.ones(D),
                 k_max=bucket_k(K))

    state = st.OptimState(warmup=opt.warmup, vp_K=K,
                          entropy_switch=(opt.entropy_switch
                                          and D >= opt.det_entropy_min_d),
                          outwarp_delta=(opt.out_warp_thresh_base
                                         if opt.fitness_shaping else None))
    if opt.ns_gp_max <= 0:
        state.stop_sampling = math.inf
    stats = st.Stats()
    sb = SearchBounds.init(plb_t, pub_t, lb_t, ub_t, opt.active_search_bound)

    key = jax.random.PRNGKey(opt.seed)
    ks = _KeySource(key)
    gp = None
    hyp_warm = None
    search_cache = None
    acq_names = tuple(_canonical_acq(a) for a in opt.search_acq_fcn)
    hedge = None
    if opt.acq_hedge and len(acq_names) > 1:
        from vbmc_tpu.hedge import AcqHedge
        hedge = AcqHedge(names=list(acq_names), decay=opt.acq_hedge_decay)
    timers = dict(active_sampling=0.0, gp_train=0.0, variational_fit=0.0,
                  finalize=0.0, warping=0.0)
    timers_prev = dict(timers)
    is_finished = False
    exitflag = 0
    msg = ""
    elbo = elbo_sd = float("nan")
    display = opt.display in ("iter",)

    if display:
        mode = "NOISY" if uncertainty_level else "EXACT"
        print(f"Beginning variational optimization assuming {mode} "
              f"observations of the log-joint.")
        print(" Iteration  f-count     Mean[ELBO]     Std[ELBO]     "
              "sKL-iter[q]   K[q]  Convergence  Action")

    while not is_finished:
        it = len(stats) + 1
        state.iter = it
        vp_old = vp
        notes = []
        if it == 1 and state.warmup:
            notes.append("start warm-up")

        # Entropy force switch (vbmc.m:523-528).
        if (state.entropy_switch and logger.func_count
                >= opt.entropy_force_switch * opt.max_fun_evals):
            state.entropy_switch = False
            notes.append("entropy switch")

        # ------------------------------------- input warping (vbmc.m:530-625)
        warp_delay = opt.warp_every_iters * max(1, state.warping_count) \
            if opt.incremental_warp_delay else opt.warp_every_iters
        do_warp = (opt.warp_roto_scaling and it > 1 and not state.warmup
                   and gp is not None and D > 1
                   and (it - state.last_warping) > warp_delay
                   and state.vp_K >= opt.warp_min_k
                   and stats.last.rindex < opt.warp_tol_reliability)
        if do_warp:
            t_warp = time.monotonic()
            from vbmc_tpu import warp as warp_mod
            idx_b = st.best_iteration(stats, safe_sd=opt.best_safe_sd,
                                      frac_back=opt.best_frac_back,
                                      rank_criterion=opt.rank_criterion)
            vp_for_warp = stats.iterations[idx_b].vp

            snapshot = dict(
                vp=vp, gp=gp, trinfo=logger.trinfo, plb_t=plb_t.copy(),
                pub_t=pub_t.copy(), sb_lb=sb.lb.copy(), sb_ub=sb.ub.copy(),
                sb_lbh=sb.lb_hard.copy(), sb_ubh=sb.ub_hard.copy(),
                hyp_warm=hyp_warm, hyp_runcov=state.hyp_runcov,
                run_mean=state.run_mean, run_cov=state.run_cov,
                elbo=elbo, elbo_sd=elbo_sd,
                recompute=state.recompute_var_post)

            trinfo_old_warp = logger.trinfo
            trinfo_new = warp_mod.compute_rotoscale(
                vp_for_warp, corr_thresh=opt.warp_roto_corr_thresh,
                cov_reg=opt.warp_cov_reg)
            seed_w = int(rng.integers(2 ** 31 - 1))
            plb_t, pub_t = warp_mod.update_plausible_bounds(
                trinfo_new, plb, pub, seed_w)
            # Hard bounds cannot be pushed through a rotation (inf * 0);
            # the transformed space is unbounded, and the hard-bound check
            # happens in original coordinates (`warp_input_vbmc.m:132-148`:
            # only the *search box* is remapped, by sampling).
            lb_t_new = np.full(D, -np.inf)
            ub_t_new = np.full(D, np.inf)
            sb_lb_new, sb_ub_new = warp_mod.remap_search_box(
                trinfo_old_warp, trinfo_new, sb.lb, sb.ub, seed_w + 1)
            logger.retransform(trinfo_new)
            vp, hyp_warped = warp_mod.warp_gp_and_vp(
                trinfo_new, vp, gp, cfg, temperature=opt.temperature)
            sb = SearchBounds(lb=sb_lb_new, ub=sb_ub_new,
                              lb_hard=lb_t_new, ub_hard=ub_t_new)
            if opt.bandwidth > 0:
                opt.delta_smoothing = opt.bandwidth * (pub_t - plb_t)
            hyp_warm = hyp_warped
            state.hyp_runcov = None
            state.run_mean = None
            state.run_cov = None
            state.warping_count += 1
            state.last_warping = it
            state.last_successful_warping = it
            notes.append("rotoscale")

            if opt.warp_undo_check:
                # Retrain GP and refit VP in the warped space; undo if the
                # ELBO regresses (vbmc.m:566-624).
                k_gp2, k_vp2 = ks(), ks()
                topts = _gp_train_options(state, stats, opt, logger,
                                          uncertainty_level)
                X_tr, y_tr, s2_tr = logger.training_data(
                    noise_shaping=_noise_shaping if opt.noise_shaping else None,
                    options=opt)
                cfg = _recenter_cfg(cfg, X_tr, y_tr)
                gp, gpinfo_w = train_gp(k_gp2, cfg, X_tr, y_tr, s2_tr,
                                        plb_t, pub_t, topts, hyp0=hyp_warped)
                n_fast_w = int(math.ceil(opt.evalopt("ns_elbo", state.vp_K)))
                res_w = vpoptimize(k_vp2, cfg, vp, gp, state.vp_K, opt,
                                   warmup=state.warmup,
                                   entropy_switch=state.entropy_switch,
                                   n_fast_opts=n_fast_w,
                                   n_slow_opts=opt.elbo_starts)
                elbo_w, elbo_sd_w = res_w.elbo, res_w.elbo_sd
                fail = (elbo_w < snapshot["elbo"] + opt.warp_tol_improvement
                        or elbo_sd_w > (snapshot["elbo_sd"]
                                        * opt.warp_tol_sd_multiplier
                                        + opt.warp_tol_sd_base))
                if fail:
                    vp = snapshot["vp"]
                    gp = snapshot["gp"]
                    logger.retransform(snapshot["trinfo"])
                    plb_t, pub_t = snapshot["plb_t"], snapshot["pub_t"]
                    if opt.bandwidth > 0:
                        opt.delta_smoothing = opt.bandwidth * (pub_t - plb_t)
                    sb = SearchBounds(lb=snapshot["sb_lb"],
                                      ub=snapshot["sb_ub"],
                                      lb_hard=snapshot["sb_lbh"],
                                      ub_hard=snapshot["sb_ubh"])
                    hyp_warm = snapshot["hyp_warm"]
                    state.hyp_runcov = snapshot["hyp_runcov"]
                    state.run_mean = snapshot["run_mean"]
                    state.run_cov = snapshot["run_cov"]
                    state.last_successful_warping = -math.inf
                    state.warping_count += 1  # failed warp counts twice
                    notes.append("undo")
                else:
                    vp = res_w.vp
                    state.vp_K = int(np.sum(to_np(vp.kmask)))
                    hyp_warm = gpinfo_w["hyp_full"]
                    state.recompute_var_post = True
            timers["warping"] += time.monotonic() - t_warp

        # ------------------------------------------------ active sampling
        t = time.monotonic()
        k_as = ks()
        if state.skip_active_sampling:
            state.skip_active_sampling = False
        elif gp is None:
            cache_t, _ = initial_design(
                k_as, logger, opt.fun_eval_start, plb_t, pub_t,
                x0_cache=direct_np(trinfo, x0),
                fvals_cache=np.asarray(opt.fvals, float)
                if opt.fvals is not None else None,
                init_design=opt.init_design)
            if cache_t is not None and len(cache_t):
                # Keep the leftover cache in ORIGINAL space so it survives
                # input warps (`activesample_vbmc.m:545-558` search cache).
                from vbmc_tpu.transforms import inverse_np as _inv_np
                search_cache = _inv_np(logger.trinfo, cache_t)
        else:
            if hedge is not None:
                acq_name = hedge.choose(rng)
            else:
                acq_name = acq_names[int(rng.integers(len(acq_names)))]

            # Full per-point updates near warmup end / unstable runs
            # (noisy-target default, `activesample_vbmc.m:46-76`).
            rindex_prev = stats.last.rindex if len(stats) else math.inf
            full_update = (
                (opt.active_sample_gp_update or opt.active_sample_vp_update)
                and ((it - opt.active_sample_full_update_past_warmup)
                     <= state.last_warmup
                     or rindex_prev > opt.active_sample_full_update_threshold))

            quick_updater = None
            if full_update and (opt.active_sample_gp_update
                                or opt.active_sample_vp_update):
                # In-iteration quick updates (the reference's options_update
                # with looser active tolerances, `activesample_vbmc.m:59-63`):
                # the posterior moved by ONE datapoint, so GP chains
                # warm-start at the previous hyperparameter samples with a
                # short burn-in and the whole retrain+refit runs as one
                # fused device program (`quick_update.py`).
                from vbmc_tpu.quick_update import QuickUpdater
                topts_q = _gp_train_options(state, stats, opt, logger,
                                            uncertainty_level)
                quick_updater = QuickUpdater(
                    cfg, opt, topts_q, plb_t, pub_t, warmup=state.warmup,
                    entropy_switch=state.entropy_switch, K=state.vp_K,
                    do_gp=bool(opt.active_sample_gp_update),
                    do_vp=bool(opt.active_sample_vp_update),
                    noise_shaping=_noise_shaping if opt.noise_shaping
                    else None)

            gp, vp = active_sample(
                k_as, cfg, logger, opt.fun_evals_per_iter, vp, gp, sb, opt,
                acq_name=acq_name, tol_gp_var=opt.tol_gp_var,
                full_update=full_update,
                quick_updater=quick_updater,
                fess_thresh=opt.active_sample_fess_thresh,
                optim_state=state,
                search_cache=(direct_np(logger.trinfo, search_cache)
                              if search_cache is not None
                              and len(search_cache) else None))
        timers["active_sampling"] += time.monotonic() - t

        # ------------------------------------------------------ GP training
        t = time.monotonic()
        k_gp = ks()
        topts = _gp_train_options(state, stats, opt, logger,
                                  uncertainty_level)
        X_tr, y_tr, s2_tr = logger.training_data(
            noise_shaping=_noise_shaping if opt.noise_shaping else None,
            options=opt)
        # Warm-start hyperparameters from previous iterations
        # (`gptrain_vbmc.m:36-50`).
        hyp0 = _collect_hyp_starts(stats, hyp_warm, topts.ninit)
        cfg = _recenter_cfg(cfg, X_tr, y_tr)
        gp, gpinfo = train_gp(k_gp, cfg, X_tr, y_tr, s2_tr, plb_t, pub_t,
                              topts, hyp0=hyp0,
                              host_seed=int(rng.integers(2 ** 31 - 1)))
        hyp_warm = gpinfo["hyp_full"]
        _update_hyp_runcov(state, gpinfo["hyp_full"], opt)
        timers["gp_train"] += time.monotonic() - t

        # ------------------------------------------- variational optimization
        t = time.monotonic()
        K_new = st.update_K(state, stats, opt)
        n_fast = int(math.ceil(opt.evalopt("ns_elbo", K_new)))
        if state.recompute_var_post or opt.always_refit_var_post:
            n_slow = opt.elbo_starts
            state.recompute_var_post = False
        else:
            n_fast = int(math.ceil(n_fast * opt.ns_elbo_incr))
            n_slow = 1
        k_vp = ks()
        res = vpoptimize(k_vp, cfg, vp, gp, K_new, opt,
                         warmup=state.warmup,
                         entropy_switch=state.entropy_switch,
                         n_fast_opts=n_fast, n_slow_opts=n_slow,
                         host_seed=int(rng.integers(2 ** 31 - 1)))
        vp = res.vp
        state.vp_K = int(np.sum(to_np(vp.kmask)))
        elbo, elbo_sd = res.elbo, res.elbo_sd
        if opt.temperature > 1:
            from vbmc_tpu.vp import vp_train2real
            _, elbo, elbo_sd = vp_train2real(vp, opt.temperature, elbo,
                                             elbo_sd)
        timers["variational_fit"] += time.monotonic() - t

        # ------------------------------------------------------- finalize
        t = time.monotonic()
        k_kl = ks()
        # All finalize metrics dispatched first, then ONE blocking pull:
        # iteration sKL, max-LCB over training points, running moments
        # (vbmc.m:779-793), the GP noise field for sn2hpd, and (debug) the
        # true-moment KL.
        kld_dev = vp_kldiv(vp, vp_old, n_samples=10 ** 5,
                           gauss_flag=opt.kl_gauss, key=k_kl)
        (fb_dev, vt_dev), ns_chunks = _predict_padded_dev(cfg, gp, X_tr)
        mom_dev = vp_moments(vp, orig_flag=False)
        true_mom_dev = None
        if opt.true_mean is not None and opt.true_cov is not None:
            k_mom = ks()
            true_mom_dev = vp_moments(vp, orig_flag=True, n_samples=10 ** 5,
                                      key=k_mom)
        kld, fb_h, vt_h, (mu_t, cov_t), sn2_host, true_mom = jax.device_get(
            (kld_dev, fb_dev, vt_dev, mom_dev, gp.sn2, true_mom_dev))
        fbar = _assemble_padded(fb_h, ns_chunks)
        vtot = _assemble_padded(vt_h, ns_chunks)

        sKL = max(0.0, 0.5 * float(np.sum(kld)))
        lcb = (fbar
               - opt.elcbo_impro_weight * np.sqrt(np.maximum(vtot, 0.0)))
        lcbmax = float(np.max(lcb))
        state.sn2hpd = _estimate_sn2hpd(cfg, gp, logger, sn2_host)

        sKL_true = None
        if true_mom is not None:
            kl1, kl2 = mvn_kl(np.asarray(true_mom[0]),
                              np.asarray(true_mom[1]),
                              np.asarray(opt.true_mean, float),
                              np.asarray(opt.true_cov, float))
            sKL_true = 0.5 * float(kl1 + kl2)

        mu_t, cov_t = np.asarray(mu_t), np.asarray(cov_t)
        if state.run_mean is None:
            state.run_mean, state.run_cov = mu_t, cov_t
            state.last_run_avg = logger.n_train
        else:
            n_new = logger.n_train - state.last_run_avg
            w_run = opt.moments_run_weight ** n_new
            state.run_mean = w_run * state.run_mean + (1 - w_run) * mu_t
            state.run_cov = w_run * state.run_cov + (1 - w_run) * cov_t
            state.last_run_avg = logger.n_train
        timers["finalize"] += time.monotonic() - t

        stats.add(st.IterStats(
            iter=it, elbo=elbo, elbo_sd=elbo_sd, sKL=sKL, sKL_true=sKL_true,
            K=state.vp_K, N=logger.n_train, neff=logger.neff,
            func_count=logger.func_count, warmup=state.warmup,
            pruned=res.pruned, varss=res.varss, lcbmax=lcbmax, vp=vp, gp=gp,
            gp_hyp=np.asarray(to_np(gp.hyp))[
                np.asarray(to_np(gp.hyp_mask), bool)],
            gp_hyp_full=gpinfo["hyp_full"], gp_ns=gpinfo["ns_samples"],
            timer={k: round(timers[k] - timers_prev.get(k, 0.0), 4)
                   for k in ("active_sampling", "gp_train",
                             "variational_fit", "finalize", "warping")}))
        timers_prev = dict(timers)
        # Algorithmic-cost model (`activesample_vbmc.m:185-204`): recorded
        # per iteration; consumed by the repeated-observation logic.
        stats.last.t_algoperfuneval = st.update_cost_model(state, stats)

        # -------------------------------------------- termination & warmup
        is_finished, exitflag, msg, t_notes = st.check_termination(
            state, stats, opt, logger.func_count)
        notes += t_notes

        if state.warmup and it > 1:
            if opt.recompute_lcb_max:
                state.lcbmax_vec = _recompute_lcbmax(cfg, gp, logger, stats,
                                                     opt)
            w_notes, trim_flag = st.check_warmup(state, stats, opt, logger)
            notes += w_notes
            if trim_flag:
                gp = gp_reupdate(cfg, gp, logger)
            if not state.warmup:
                state.hyp_runcov = None
        stats.last.warmup = state.warmup

        # Fitness-shaping threshold check (vbmc.m:838-846): raise the warp
        # threshold when the posterior's low-density tail reaches too far
        # below ymax.
        if (state.outwarp_delta is not None
                and state.R < opt.warp_tol_reliability):
            k_ow = ks()
            Xrnd = np.asarray(vp_rnd(vp, k_ow, 2 ** 14, orig_flag=False))
            ymu, _ = _predict_padded(cfg, gp, Xrnd)
            ydelta = max(0.0, logger.ymax - float(np.quantile(ymu, 1e-3)))
            if (ydelta > state.outwarp_delta * opt.out_warp_thresh_tol
                    and state.R < 1):
                state.outwarp_delta *= opt.out_warp_thresh_mult

        # Hedge reward: ELCBO improvement over the previous iteration
        # (`vbmc.m:848-850`, `acqhedge_vbmc.m:28-56`).
        if hedge is not None and it > 1:
            prev = stats.iterations[-2]
            impro = ((elbo - opt.elcbo_impro_weight * elbo_sd)
                     - (prev.elbo - opt.elcbo_impro_weight * prev.elbo_sd))
            hedge.update(impro, opt.fun_evals_per_iter)

        if opt.output_fcn is not None:
            # Reference parity (`vbmc.m:853-858`): an OutputFcn returning
            # true stops the run after the current iteration.
            stop_req = opt.output_fcn(dict(
                iteration=it, elbo=elbo, elbo_sd=elbo_sd,
                sKL=sKL, K=state.vp_K, rindex=state.R,
                func_count=logger.func_count, vp=vp,
                warmup=state.warmup, timer=stats.last.timer))
            if stop_req:
                is_finished = True
                msg = msg or "Inference stopped by the user OutputFcn."

        # Live iteration plot (`private/vbmc_iterplot.m`).
        if opt.plot:
            from vbmc_tpu.plotting import iteration_plot
            try:
                iteration_plot(stats, vp, logger)
            except Exception as e:
                import warnings
                warnings.warn(f"iteration plot disabled: {e!r}")
                opt.plot = False

        if display:
            print(f" {it:9d} {logger.func_count:8d} {elbo:14.2f} "
                  f"{elbo_sd:13.2f} {sKL:15.2f} {state.vp_K:6d} "
                  f"{state.R:12.3g}     {', '.join(notes)}")

    # ---------------------------------------------------------- finalize run
    t_final = time.monotonic()
    idx_best = st.best_iteration(stats, safe_sd=opt.best_safe_sd,
                                 frac_back=opt.best_frac_back,
                                 rank_criterion=opt.rank_criterion)
    vp_best = stats.iterations[idx_best].vp
    elbo = stats.iterations[idx_best].elbo
    elbo_sd = stats.iterations[idx_best].elbo_sd

    # Final boost to MinFinalComponents (cf. `misc/finalboost_vbmc.m`).
    vp_train = vp_best
    K_best = int(np.sum(to_np(vp_best.kmask)))
    K_boost = max(opt.min_final_components, K_best)
    if K_best < K_boost:
        k_boost = ks()
        n_fast = int(math.ceil(opt.evalopt("ns_elbo", K_boost)
                               * opt.ns_elbo_incr))
        # The boost must use the GP of the best ITERATION, not the final GP
        # (`finalboost_vbmc.m:36`): after an input warp the two live in
        # different transformed spaces and mixing them corrupts the ELBO.
        gp_best = stats.iterations[idx_best].gp or gp
        res_boost = vpoptimize(
            k_boost, cfg, vp_best, gp_best, K_boost, opt, warmup=False,
            entropy_switch=state.entropy_switch, n_fast_opts=n_fast,
            n_slow_opts=1, n_ent=opt.evalopt("ns_ent_boost", K_boost),
            n_ent_fine=opt.evalopt("ns_ent_fine_boost", K_boost),
            n_ent_fast=opt.evalopt("ns_ent_fast_boost", K_boost),
            prune=False, host_seed=int(rng.integers(2 ** 31 - 1)))
        vp = res_boost.vp
        elbo, elbo_sd = res_boost.elbo, res_boost.elbo_sd
    else:
        vp = vp_best

    stable = stats.iterations[idx_best].stable
    convergence = "probable" if stable else "no"
    if exitflag == 0 and not stable:
        msg = msg or ("Inference terminated without reaching stability; "
                      "examine the run diagnostics.")
    if opt.display in ("iter", "final"):
        print(msg)
        print(f"Estimated ELBO: {float(elbo):.3f} +/- {float(elbo_sd):.3f} "
              f"[{convergence} convergence, {logger.func_count} fcn evals]")

    # Automatic retry from the best solution (cf. `vbmc.m:968-1009`).
    if exitflag < 1 and opt.retry_max_fun_evals > 0:
        if display:
            print("Attempting a second inference run from the current "
                  "posterior.")
        retry_user = dataclasses.replace(
            options, max_fun_evals=opt.retry_max_fun_evals,
            retry_max_fun_evals=0, seed=opt.seed + 1)
        try:
            res2 = vbmc(fun, vp, lb, ub, None, None, options=retry_user)
            if res2.exitflag >= 1 or (res2.elbo - opt.best_safe_sd
                                      * res2.elbo_sd) > (elbo - opt.best_safe_sd
                                                         * elbo_sd):
                res2.timers["first_run"] = time.monotonic() - t0
                return res2
        except Exception as e:  # keep the first run's result on failure
            if display:
                print(f"Retry run failed ({e}); returning first result.")

    if opt.temperature > 1:
        from vbmc_tpu.vp import vp_train2real
        vp, elbo, elbo_sd = vp_train2real(vp, opt.temperature, elbo, elbo_sd)

    timers["final_boost"] = time.monotonic() - t_final
    timers["total"] = time.monotonic() - t0
    overhead = (timers["total"] / logger.total_fun_eval_time - 1.0
                if logger.total_fun_eval_time > 0 else float("inf"))
    return VBMCResult(
        vp=vp, elbo=float(elbo), elbo_sd=float(elbo_sd), exitflag=exitflag,
        message=msg, stats=stats, optim_state=state, logger=logger,
        vp_train=vp_train, func_count=logger.func_count,
        iterations=len(stats), convergence_status=convergence,
        idx_best=idx_best, timers=timers, overhead=overhead)


def vbmc_sweep(fun, x0=None, lb=None, ub=None, plb=None, pub=None,
               options: Optional[VBMCOptions] = None, n_runs: int = 3,
               dispatch: str = "local", **dispatch_kwargs):
    """Multi-run validation sweep (cf. the `vbmc_diagnostics` workflow):
    run VBMC ``n_runs`` times with different seeds and cross-validate.

    dispatch="local": runs execute sequentially in-process; returns
    (DiagnosticsResult, [VBMCResult, ...]).
    dispatch="subprocess": each run in its OWN worker process — the
    multi-host scale-out path (`parallel/launch.py`; pass ``launcher``
    (e.g. an ssh/mpirun prefix) or ``env_per_run`` to place workers on
    different hosts/accelerators). The target and callable options must be
    picklable. Returns (DiagnosticsResult, [(vp, elbo, elbo_sd, meta), ...]).
    """
    import dataclasses as _dc
    from vbmc_tpu.diagnostics import vbmc_diagnostics

    if options is None:
        options = VBMCOptions()
    if dispatch == "subprocess":
        from vbmc_tpu.parallel.launch import dispatch_runs
        return dispatch_runs(fun, x0, lb, ub, plb, pub, options=options,
                             n_runs=n_runs, **dispatch_kwargs)
    results = []
    for i in range(n_runs):
        opts_i = _dc.replace(options, seed=options.seed + 1000 * i)
        results.append(vbmc(fun, x0, lb, ub, plb, pub, options=opts_i))
    return vbmc_diagnostics(results), results


class _KeySource:
    """Host-resident PRNG key pool.

    One device split + one pull at construction; every draw afterwards is a
    host-array upload instead of an eager `jax.random.split` dispatch and
    pull (the main loop draws ~6 keys per iteration)."""

    def __init__(self, key, n: int = 8192):
        self._host = np.asarray(jax.device_get(jax.random.split(key, n)))
        self._i = 0

    def __call__(self):
        if self._i >= self._host.shape[0]:   # refill (practically unreached)
            self._host = np.asarray(jax.device_get(
                jax.random.split(jnp.asarray(self._host[-1]), 8192)))
            self._i = 0
        k = jnp.asarray(self._host[self._i])
        self._i += 1
        return k


_numerics_configured = False


def _configure_numerics():
    """One-time numeric/runtime configuration.

    On a GPU the default matmul precision runs float32 products on the
    tensor cores in TF32 (a 10-bit mantissa), which destroys the small
    differences the quadrature covariance J_jk = prior_term - data_term is
    made of (multi-nat ELBO-SD spikes). "highest" keeps true float32 and
    keeps GPU results close to the CPU's; these matrices are small.
    The persistent compilation cache follows `utils/compile_cache.py`.
    """
    global _numerics_configured
    if _numerics_configured:
        return
    from vbmc_tpu.utils.compile_cache import configure_compile_cache
    jax.config.update("jax_default_matmul_precision", "highest")
    configure_compile_cache()
    _numerics_configured = True


def _canonical_acq(name: str) -> str:
    aliases = {"acqf": "prospective", "prospective": "prospective",
               "acqfsn2": "prospective_sn2", "prospective_sn2": "prospective_sn2",
               "acqflog": "prospective_log", "prospective_log": "prospective_log",
               "us": "us", "acqus": "us", "eig": "eig", "acqeig": "eig",
               "viqr": "viqr", "acqviqr": "viqr",
               "imiqr": "imiqr", "acqimiqr": "imiqr"}
    return aliases[name]


def _collect_hyp_starts(stats: st.Stats, hyp_warm, ninit: int):
    """Recycle hyperparameter samples from the most recent iterations."""
    pool = []
    if hyp_warm is not None:
        pool.append(np.atleast_2d(hyp_warm))
    if len(stats):
        for itstat in stats.iterations[len(stats) // 2:]:
            if itstat.gp_hyp is not None:
                pool.append(np.atleast_2d(itstat.gp_hyp))
    if not pool:
        return None
    cat = np.concatenate(pool, axis=0)
    n_keep = max(int(ninit // 2), 4)
    if cat.shape[0] > n_keep:
        idx = np.random.default_rng(0).permutation(cat.shape[0])[:n_keep]
        cat = cat[idx]
    return np.unique(cat, axis=0)


def _noise_shaping(s2, y, options):
    """Add artificial noise to low-density observations
    (cf. `misc/noiseshaping_vbmc.m`)."""
    if s2 is None:
        s2 = np.full(y.shape, options.tol_gp_noise ** 2)
    ydelta = np.maximum(0.0, np.max(y) - y - options.noise_shaping_threshold)
    return s2 + (options.noise_shaping_factor * ydelta) ** 2
