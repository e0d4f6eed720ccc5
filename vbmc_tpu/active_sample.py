"""Active sampling: initial design, search-set generation, acquisition sweep
and CMA-ES refinement, target evaluation, and GP posterior refresh
(cf. `private/activesample_vbmc.m`, `misc/initdesign_vbmc.m`).

The 2^13-candidate acquisition sweep and the CMA-ES refinement are jitted
batch kernels; the loop over the (default 5) new points per iteration stays
host-side because each point requires an external target evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.gp import GP
from vbmc_tpu.gp.fit import _build_gp_jit, get_hpd
from vbmc_tpu.function_logger import FunctionLogger
from vbmc_tpu.vp import VariationalPosterior, vp_rnd, vp_moments
from vbmc_tpu.acquisitions import evaluate_acquisition, AcqState, ACQ_INFO
from vbmc_tpu.samplers.cmaes import cmaes_minimize
from functools import partial


@partial(jax.jit, static_argnames=("cfg", "name", "max_evals", "popsize",
                                   "smooth"))
def _cmaes_refine(cfg, name, key, x0, insigma, lb, ub, vp, gp, state,
                  max_evals: int, popsize: int, smooth: bool = False):
    """Whole CMA-ES refinement as one compiled kernel (scan over
    generations; population evaluated as a batch)."""
    def f_batch(xs):
        return evaluate_acquisition(cfg, name, xs, vp, gp, state,
                                    smooth=smooth)
    return cmaes_minimize(key, f_batch, x0, insigma, lb, ub,
                          max_evals=max_evals, popsize=popsize)


@partial(jax.jit, static_argnames=("cfg", "name", "max_evals", "popsize"))
def _cmaes_refine_is(cfg, name, key, x0, insigma, lb, ub, vp, gp, state, ais,
                     max_evals: int, popsize: int):
    from vbmc_tpu.active_is import evaluate_is_acquisition

    def f_batch(xs):
        return evaluate_is_acquisition(cfg, name, xs, vp, gp, state, ais)
    return cmaes_minimize(key, f_batch, x0, insigma, lb, ub,
                          max_evals=max_evals, popsize=popsize)
from vbmc_tpu.utils.math import bucket_n, pad_to


@dataclasses.dataclass
class SearchBounds:
    lb: np.ndarray          # current search box (transformed space)
    ub: np.ndarray
    lb_hard: np.ndarray     # transformed hard bounds
    ub_hard: np.ndarray

    @staticmethod
    def init(plb, pub, lb_hard, ub_hard, mult: float):
        prange = pub - plb
        return SearchBounds(
            lb=np.maximum(plb - prange * mult, lb_hard),
            ub=np.minimum(pub + prange * mult, ub_hard),
            lb_hard=lb_hard, ub_hard=ub_hard)

    def expand(self, xnew: np.ndarray) -> bool:
        """Expand the search box when new points land near its edges
        (`activesample_vbmc.m:492-508`). Returns True when the box moved
        (callers re-upload the device copy only then)."""
        delta = 0.05 * (self.ub - self.lb)
        near_lo = np.abs(xnew - self.lb) < delta
        near_hi = np.abs(xnew - self.ub) < delta
        if not (near_lo.any() or near_hi.any()):
            return False
        old_lb, old_ub = self.lb.copy(), self.ub.copy()
        self.lb[near_lo] = np.maximum(self.lb_hard[near_lo],
                                      (self.lb - delta)[near_lo])
        self.ub[near_hi] = np.minimum(self.ub_hard[near_hi],
                                      (self.ub + delta)[near_hi])
        return bool(np.any(self.lb != old_lb) or np.any(self.ub != old_ub))


def initial_design(key, logger: FunctionLogger, n_evals: int,
                   plb, pub, x0_cache: Optional[np.ndarray] = None,
                   fvals_cache: Optional[np.ndarray] = None,
                   init_design: str = "plausible"):
    """First batch of evaluations: provided starting points + random draws
    (`initdesign_vbmc.m:10-28`): 'plausible' draws uniformly in the
    plausible box; 'narrow' draws in a 0.1x plausible-box window around the
    first starting point, clipped to the box (`initdesign_vbmc.m:16-19`).

    An oversized starting cache is thinned by k-means clustering, keeping
    the best-density representative of each cluster
    (`initdesign_vbmc.m:30-45`); the rest is returned as the search cache
    consumed by `get_search_points` (`activesample_vbmc.m:545-558`).
    Returns (search_cache, search_cache_y) — leftover cache points (possibly
    empty)."""
    D = plb.shape[0]
    pts = []
    fv = (np.asarray(fvals_cache, float).ravel()
          if fvals_cache is not None else None)
    leftover = np.zeros((0, D))
    leftover_y = np.zeros(0)
    if x0_cache is not None and len(x0_cache):
        Xc = np.asarray(x0_cache, float).reshape(-1, D)
        if Xc.shape[0] > n_evals and n_evals > 0:
            from vbmc_tpu.utils.kmeans import kmeans
            _, assign = kmeans(Xc, n_evals, seed=0)
            chosen = np.zeros(Xc.shape[0], dtype=bool)
            for c in range(n_evals):
                members = np.where(assign == c)[0]
                if members.size == 0:
                    continue
                if fv is not None and fv.size >= Xc.shape[0]:
                    best = members[int(np.nanargmax(
                        np.where(np.isfinite(fv[members]), fv[members],
                                 -np.inf)))]
                else:
                    best = members[0]
                chosen[best] = True
            # Top up underfull selections with unchosen points.
            for j in np.where(~chosen)[0]:
                if chosen.sum() >= n_evals:
                    break
                chosen[j] = True
            leftover = Xc[~chosen]
            leftover_y = (fv[~chosen] if fv is not None
                          and fv.size >= Xc.shape[0]
                          else np.full(leftover.shape[0], np.nan))
            idx = np.where(chosen)[0]
            Xc = Xc[idx]
            fv = fv[idx] if fv is not None and fv.size else None
        pts.append(Xc)
    n_have = sum(p.shape[0] for p in pts)
    n_rand = max(n_evals - n_have, 0)
    if n_rand > 0:
        u = np.asarray(jax.random.uniform(key, (n_rand, D)))
        if init_design == "plausible":
            pts.append(plb + u * (pub - plb))
        elif init_design == "narrow":
            xstart = pts[0][0] if pts and len(pts[0]) else 0.5 * (plb + pub)
            Xr = xstart[None, :] + (u - 0.5) * 0.1 * (pub - plb)[None, :]
            pts.append(np.clip(Xr, plb, pub))
        else:
            raise ValueError(f"Unknown initial design '{init_design}'.")
    X = np.concatenate(pts, axis=0)[:n_evals]
    for i, x in enumerate(X):
        if fv is not None and i < len(fv) and np.isfinite(fv[i]):
            logger.add(x, float(fv[i]))
        else:
            logger.evaluate(x)
    return leftover, leftover_y


def get_search_points(key, n_search: int, vp: VariationalPosterior,
                      logger: FunctionLogger, sb: SearchBounds, options,
                      search_cache: Optional[np.ndarray] = None) -> np.ndarray:
    """Generate the fast acquisition search set
    (`activesample_vbmc.m:545-639`): a mixture of heavy-tailed VP samples,
    MVN moment-matched samples, box-uniform samples, and VP samples."""
    D = vp.D
    parts = []
    n_rem = n_search

    n_sc = int(round(options.search_cache_frac * n_search))
    if n_sc > 0 and search_cache is not None and len(search_cache):
        parts.append(search_cache[:n_sc])

    n_heavy = int(round(options.heavy_tail_search_frac * n_search))
    if n_heavy > 0:
        k1, key = jax.random.split(key)
        parts.append(np.asarray(vp_rnd(vp, k1, n_heavy, orig_flag=False,
                                       df=3.0)))
    n_mvn = int(round(options.mvn_search_frac * n_search))
    if n_mvn > 0:
        k1, key = jax.random.split(key)
        mu, cov = vp_moments(vp, orig_flag=False)
        L = np.linalg.cholesky(np.asarray(cov)
                               + 1e-12 * np.eye(D))
        eps = np.asarray(jax.random.normal(k1, (n_mvn, D)))
        parts.append(np.asarray(mu)[None, :] + eps @ L.T)

    n_hpd = int(round(options.hpd_search_frac * n_search))
    if n_hpd > 0:
        k1, key = jax.random.split(key)
        X, y, _ = logger.training_data()
        hpd_min, hpd_max = options.hpd_frac / 8, options.hpd_frac
        u = np.asarray(jax.random.uniform(k1, (4,)))
        fracs = np.sort(np.concatenate([
            u * (hpd_max - hpd_min) + hpd_min, [hpd_min, hpd_max]]))
        n_vec = np.diff(np.round(np.linspace(0, n_hpd, len(fracs) + 1))).astype(int)
        for frac, n_i in zip(fracs, n_vec):
            if n_i == 0:
                continue
            X_hpd, _ = get_hpd(X, y, frac)
            if X_hpd.shape[0] < 2:
                mu_h = X[np.argmax(y)]
                cov_h = np.cov(X.T) + 1e-12 * np.eye(D)
            else:
                mu_h = X_hpd.mean(0)
                cov_h = np.cov(X_hpd.T, bias=True) + 1e-12 * np.eye(D)
            k2, key = jax.random.split(key)
            eps = np.asarray(jax.random.normal(k2, (int(n_i), D)))
            parts.append(mu_h[None, :] + eps @ np.linalg.cholesky(cov_h).T)

    n_box = int(round(options.box_search_frac * n_search))
    if n_box > 0:
        k1, key = jax.random.split(key)
        X, _, _ = logger.training_data()
        diam = X.max(0) - X.min(0)
        if np.all(np.isfinite(sb.lb)) and np.all(np.isfinite(sb.ub)):
            box_lb = np.maximum(X.min(0) - 0.5 * diam, sb.lb)
            box_ub = np.minimum(X.max(0) + 0.5 * diam, sb.ub)
        else:
            box_lb = X.min(0) - 0.5 * diam
            box_ub = X.max(0) + 0.5 * diam
        u = np.asarray(jax.random.uniform(k1, (n_box, D)))
        parts.append(box_lb + u * (box_ub - box_lb))

    n_have = sum(p.shape[0] for p in parts)
    n_vp = max(n_search - n_have, 0)
    if n_vp > 0:
        k1, key = jax.random.split(key)
        parts.append(np.asarray(vp_rnd(vp, k1, n_vp, orig_flag=False,
                                       balance_flag=True, permute=False)))
    X = np.concatenate(parts, axis=0)[:n_search]
    return np.clip(X, sb.lb, sb.ub)


@partial(jax.jit, static_argnames=("cfg", "name", "n_search", "n_heavy",
                                   "n_mvn", "n_box", "max_evals", "popsize",
                                   "smooth", "refine"))
def _propose_point(cfg: GPConfig, name: str, key, salt, vp, gp, state,
                   sb_lb, sb_ub, n_search: int, n_heavy: int, n_mvn: int,
                   n_box: int, max_evals: int, popsize: int, smooth: bool,
                   refine: bool):
    """One acquisition step as a SINGLE device program: candidate
    generation (heavy-tail/MVN/box/VP mixture, `getSearchPoints`
    `activesample_vbmc.m:545-639`) -> acquisition sweep -> argmin ->
    CMA-ES refinement. Fusing the step removes ~10 host<->device round
    trips and dispatches per point.

    Returns (x_best (D,), f_sweep_best ()). Requires the default search-set
    composition (no HPD / cache fractions) and CMA-ES refinement with VP
    moment init; the host path remains for everything else.

    ``salt`` (device scalar, the point index) derives the per-point key
    IN-TRACE: the host loop issues zero eager PRNG dispatches per point.
    """
    key = jax.random.fold_in(key, salt)
    Xs, cov_t = _gen_candidates(key, vp, gp, sb_lb, sb_ub, n_search,
                                n_heavy, n_mvn, n_box)

    def f_batch(xs):
        return evaluate_acquisition(cfg, name, xs, vp, gp, state,
                                    smooth=smooth)

    acq = f_batch(Xs)

    return _argmin_and_refine(jax.random.fold_in(key, 5), Xs, acq, cov_t,
                              sb_lb, sb_ub, f_batch, max_evals, popsize,
                              refine)


def _gen_candidates(key, vp, gp, sb_lb, sb_ub, n_search: int, n_heavy: int,
                    n_mvn: int, n_box: int):
    """Device-side search-set generation (the traceable core of
    `getSearchPoints`). Returns (Xs (n_search, D), vp covariance)."""
    D = vp.mu.shape[1]
    dtype = gp.X.dtype
    k_h, k_m, k_b, k_v = jax.random.split(key, 4)

    mean_t, cov_t = vp_moments(vp, orig_flag=False)
    parts = []
    if n_heavy > 0:
        parts.append(vp_rnd(vp, k_h, n_heavy, orig_flag=False, df=3.0))
    if n_mvn > 0:
        Lc = jnp.linalg.cholesky(cov_t + 1e-12 * jnp.eye(D, dtype=dtype))
        eps = jax.random.normal(k_m, (n_mvn, D), dtype=dtype)
        parts.append(mean_t[None, :] + eps @ Lc.T)
    if n_box > 0:
        box_lb, box_ub = _train_box(gp, sb_lb, sb_ub)
        u = jax.random.uniform(k_b, (n_box, D), dtype=dtype)
        parts.append(box_lb + u * (box_ub - box_lb))
    n_vp = n_search - sum(p.shape[0] for p in parts)
    if n_vp > 0:
        parts.append(vp_rnd(vp, k_v, n_vp, orig_flag=False,
                            balance_flag=True, permute=False))
    Xs = jnp.clip(jnp.concatenate(parts, axis=0)[:n_search],
                  sb_lb[None, :], sb_ub[None, :])
    return Xs, cov_t


def _train_box(gp, sb_lb, sb_ub):
    """Box around the (masked) training inputs, clipped to finite search
    bounds (`activesample_vbmc.m:600-612`)."""
    dtype = gp.X.dtype
    m = gp.mask.astype(dtype)
    big = jnp.finfo(dtype).max
    Xmin = jnp.min(jnp.where(m[:, None] > 0, gp.X, big), axis=0)
    Xmax = jnp.max(jnp.where(m[:, None] > 0, gp.X, -big), axis=0)
    diam = Xmax - Xmin
    box_lb = jnp.where(jnp.isfinite(sb_lb),
                       jnp.maximum(Xmin - 0.5 * diam, sb_lb),
                       Xmin - 0.5 * diam)
    box_ub = jnp.where(jnp.isfinite(sb_ub),
                       jnp.minimum(Xmax + 0.5 * diam, sb_ub),
                       Xmax + 0.5 * diam)
    return box_lb, box_ub


def _argmin_and_refine(k_cma, Xs, acq, cov_t, sb_lb, sb_ub, f_batch,
                       max_evals: int, popsize: int, refine: bool):
    acq_f = jnp.where(jnp.isfinite(acq), acq, jnp.inf)
    best = jnp.argmin(acq_f)
    x0 = Xs[best]
    f0 = acq_f[best]
    if not refine:
        return x0, f0
    insigma = jnp.sqrt(jnp.maximum(jnp.diagonal(cov_t), 1e-12))
    lb_c = jnp.minimum(x0, sb_lb)
    ub_c = jnp.maximum(x0, sb_ub)
    res = cmaes_minimize(k_cma, f_batch, x0, insigma, lb_c, ub_c,
                         max_evals=max_evals, popsize=popsize)
    better = res.f_best < f0
    x = jnp.where(better, res.x_best, x0)
    return x, f0


@partial(jax.jit, static_argnames=("cfg", "name", "n_search", "n_heavy",
                                   "n_mvn", "n_box", "n_is_vp", "n_is_box",
                                   "n_is_mcmc", "mh_steps", "fess_thresh",
                                   "max_evals", "popsize"))
def _propose_point_is(cfg: GPConfig, name: str, key, salt, vp, gp, state,
                      sb_lb, sb_ub, n_search: int, n_heavy: int, n_mvn: int,
                      n_box: int, n_is_vp: int, n_is_box: int,
                      n_is_mcmc: int, mh_steps: int, fess_thresh: float,
                      max_evals: int, popsize: int):
    """Fused VIQR/IMIQR proposal: IS-state build + candidate generation +
    sweep + CMA-ES refinement as one device program (the noisy-target
    analogue of `_propose_point`; the per-point IS rebuild is what makes
    the noisy path the bench critical path). ``salt`` as in
    `_propose_point`."""
    from vbmc_tpu.active_is import build_is_state_core, \
        evaluate_is_acquisition

    k_is, k_gen, k_cma = jax.random.split(jax.random.fold_in(key, salt), 3)
    ais = build_is_state_core(k_is, cfg, name, vp, gp, n_is_vp, n_is_box,
                              n_is_mcmc, mh_steps=mh_steps,
                              fess_thresh=fess_thresh)
    Xs, cov_t = _gen_candidates(k_gen, vp, gp, sb_lb, sb_ub, n_search,
                                n_heavy, n_mvn, n_box)

    def f_batch(xs):
        return evaluate_is_acquisition(cfg, name, xs, vp, gp, state, ais)

    acq = f_batch(Xs)

    return _argmin_and_refine(k_cma, Xs, acq, cov_t, sb_lb, sb_ub, f_batch,
                              max_evals, popsize, True)


def gp_reupdate(cfg: GPConfig, gp: GP, logger: FunctionLogger) -> GP:
    """Refresh the GP posterior with current training data, keeping the
    hyperparameter samples (cf. `misc/gpreupdate.m`). The batched
    re-factorization replaces the reference's rank-1 update — one fused
    (S, N, N) Cholesky batch instead of sequential updates."""
    from vbmc_tpu.utils.hostcache import device_put_cached
    X, y, s2 = logger.training_data()
    n = X.shape[0]
    nb = bucket_n(n)
    dtype = gp.X.dtype
    Xp = device_put_cached(pad_to(X, nb), dtype=dtype)
    yp = device_put_cached(pad_to(y, nb), dtype=dtype)
    s2p = (device_put_cached(np.zeros(nb), dtype=dtype) if s2 is None
           else device_put_cached(pad_to(s2, nb), dtype=dtype))
    mask = device_put_cached(np.arange(nb) < n)
    gp_new = _build_gp_jit(cfg, Xp, yp, s2p, mask, gp.hyp, gp.hyp_mask)
    # Restore passthrough references (mirror preservation; see train_gp).
    gp_new = gp_new._replace(X=Xp, y=yp, s2=s2p, mask=mask, hyp=gp.hyp,
                             hyp_mask=gp.hyp_mask)
    from vbmc_tpu.parallel.context import shard_gp
    return shard_gp(gp_new)


def _geomean_length_scale(cfg: GPConfig, gp: GP) -> np.ndarray:
    from vbmc_tpu.utils.hostcache import to_np
    m = np.asarray(to_np(gp.hyp_mask), float)
    le = np.asarray(to_np(gp.hyp))[:, :cfg.D]
    return np.exp((le * m[:, None]).sum(0) / max(m.sum(), 1.0))


def active_sample(key, cfg: GPConfig, logger: FunctionLogger, n_points: int,
                  vp: VariationalPosterior, gp: Optional[GP],
                  sb: SearchBounds, options, *, acq_name: str,
                  tol_gp_var: float, var_log_joint=None,
                  full_update: bool = False, quick_updater=None,
                  fess_thresh: float = 1.0,
                  optim_state=None, search_cache: Optional[np.ndarray] = None):
    """Acquire ``n_points`` new evaluations; returns (gp, vp).

    ``gp`` must be trained (call `initial_design` when there is none).
    When ``full_update`` is set (noisy targets near warmup end / unstable
    runs, cf. `activesample_vbmc.m:46-76, 429-473`), the provided
    ``quick_updater(key, logger, gp, vp) -> (gp, vp, gls)`` re-trains the GP
    hyperparameters and re-fits the VP after each acquisition as ONE fused
    device program (`quick_update.py`), gated on the fractional effective
    sample size. ``optim_state`` carries the repeated-observation streak
    for noisy targets."""
    D = vp.D
    dtype = gp.X.dtype
    use_is = ACQ_INFO[acq_name]["importance_sampling"]

    # Integer dimensions are rounded through the transform
    # (`activesample_vbmc.m:219,248`, `misc/real2int_vbmc.m`).
    integer_mask = np.zeros(D, dtype=bool)
    if len(options.integer_vars):
        integer_mask[np.asarray(options.integer_vars, dtype=int)] = True
    has_int = bool(integer_mask.any())

    repeat_obs = (logger.noise_flag and options.max_repeated_observations > 0
                  and optim_state is not None)

    from vbmc_tpu.transforms import direct
    lb_eps, ub_eps = _hard_bound_eps(logger, options)
    insigma_cache = None   # vp moments reused across points until vp changes

    # Hoisted device constants: per-point uploads are one scalar (ymax) and,
    # only when the search box actually expands, its two bound vectors.
    tol_var_dev = jnp.asarray(tol_gp_var, dtype=dtype)
    lb_eps_dev = jnp.asarray(lb_eps, dtype=dtype)
    ub_eps_dev = jnp.asarray(ub_eps, dtype=dtype)
    true_dev = jnp.asarray(True)
    gls_dev = jnp.asarray(_geomean_length_scale(cfg, gp), dtype=dtype)
    sb_lb_dev = jnp.asarray(sb.lb, dtype=dtype)
    sb_ub_dev = jnp.asarray(sb.ub, dtype=dtype)
    ones_s_dev = jnp.ones(gp.s_max, dtype=dtype)
    delta_sm = getattr(options, "delta_smoothing", None)
    smooth = delta_sm is not None
    delta_dev = (jnp.asarray(delta_sm, dtype=dtype) if smooth
                 else jnp.zeros(D, dtype=dtype))
    vp_updated = False

    for i in range(n_points):
        # Fused paths derive per-point keys IN-TRACE from (key, salt=i);
        # the host-side paths fold the point index eagerly (cold paths).
        def _k(j, _i=i):
            return jax.random.fold_in(key, 3 * _i + j)

        # Default search composition + CMA-ES refinement => the whole
        # point proposal runs as ONE device program (fused fast paths).
        # Integer rounding and the repeated-observation check need host-side
        # steps between sweep and evaluation, so they use the host path.
        fused_ok = (options.search_cache_frac == 0
                    and options.hpd_search_frac == 0
                    and options.search_optimizer == "cmaes"
                    and options.search_cmaes_vp_init
                    and not has_int and not repeat_obs)

        # Importance-sampling state is rebuilt per point: the GP posterior
        # changes as evaluations accrue (`activesample_vbmc.m:208-211`).
        # On the fused path the rebuild happens inside _propose_point_is.
        if use_is and not fused_ok:
            from vbmc_tpu.active_is import build_is_state
            active_is_state = build_is_state(_k(2), cfg, acq_name, vp, gp,
                                             options)
        else:
            active_is_state = None

        # EIG needs the per-sample variance of the log-joint integral,
        # recomputed as the GP updates (`activesample_vbmc.m:152-157`).
        if acq_name == "eig":
            from vbmc_tpu.elbo import gplogjoint
            _, _, _, _, J = gplogjoint(cfg, gp, vp.mu, vp.sigma, vp.lam,
                                       vp.w, vp.kmask, compute_var=1)
            wk = vp.w * vp.kmask.astype(vp.w.dtype)
            var_log_joint = jnp.maximum(
                jnp.einsum("j,sjk,k->s", wk, J, wk), 1e-12)
        # Bandwidth smoothing (`acqwrapper_vbmc.m:12-15`): delta is set by
        # the orchestrator when options.bandwidth > 0.
        state = AcqState(
            ymax=jnp.asarray(logger.ymax, dtype=dtype),
            tol_var=tol_var_dev,
            lb_eps_orig=lb_eps_dev,
            ub_eps_orig=ub_eps_dev,
            gp_length_scale=gls_dev,
            var_log_joint=(var_log_joint if var_log_joint is not None
                           else ones_s_dev),
            regularize=true_dev,
            delta=delta_dev)

        # Fast path: the whole proposal (candidate gen + sweep + CMA-ES)
        # as one device program when the default search composition applies.
        fused = fused_ok and not use_is
        fused_is = fused_ok and use_is
        if fused or fused_is:
            ns = options.ns_search
            common = dict(
                n_search=ns,
                n_heavy=int(round(options.heavy_tail_search_frac * ns)),
                n_mvn=int(round(options.mvn_search_frac * ns)),
                n_box=int(round(options.box_search_frac * ns)),
                max_evals=options.search_max_fun_evals,
                popsize=options.search_cmaes_popsize)
            salt = jnp.asarray(i, dtype=jnp.int32)
            if fused:
                x_fused, _ = _propose_point(
                    cfg, acq_name, key, salt, vp, gp, state,
                    sb_lb_dev, sb_ub_dev,
                    smooth=smooth, refine=True, **common)
            else:
                x_fused, _ = _propose_point_is(
                    cfg, acq_name, key, salt, vp, gp, state,
                    sb_lb_dev, sb_ub_dev,
                    n_is_vp=int(
                        options.active_importance_sampling_vp_samples),
                    n_is_box=int(
                        options.active_importance_sampling_box_samples),
                    n_is_mcmc=int(
                        options.active_importance_sampling_mcmc_samples),
                    mh_steps=int(
                        options.active_importance_sampling_mh_steps),
                    fess_thresh=float(
                        options.active_importance_sampling_fess_thresh),
                    **common)
            x_best = np.asarray(x_fused)
        else:
            Xsearch = get_search_points(_k(0), options.ns_search, vp,
                                        logger, sb, options,
                                        search_cache=search_cache)
            if has_int:
                from vbmc_tpu.transforms import real_to_int
                Xsearch = np.asarray(real_to_int(
                    logger.trinfo, jnp.asarray(Xsearch), integer_mask))
            Xs = jnp.asarray(Xsearch, dtype=dtype)
            if active_is_state is not None:
                from vbmc_tpu.active_is import evaluate_is_acquisition
                acq = evaluate_is_acquisition(cfg, acq_name, Xs, vp, gp,
                                              state, active_is_state)
            else:
                acq = evaluate_acquisition(cfg, acq_name, Xs, vp, gp, state,
                                           smooth=smooth)
            acq_np = np.asarray(acq)
            best = int(np.nanargmin(np.where(np.isfinite(acq_np), acq_np,
                                             np.inf)))
            x_best = Xsearch[best]
            f_best = acq_np[best]

        # CMA-ES refinement of the winner (`activesample:246-330`).
        if (not fused and not fused_is
                and options.search_optimizer == "cmaes"):
            popsize = options.search_cmaes_popsize
            if options.search_cmaes_vp_init:
                if insigma_cache is None:
                    _, cov = vp_moments(vp, orig_flag=False)
                    insigma_cache = np.sqrt(np.maximum(
                        np.diag(np.asarray(cov)), 1e-12))
                insigma = insigma_cache
            else:
                X_t, y_t, _ = logger.training_data()
                X_hpd, _ = get_hpd(X_t, y_t, options.hpd_frac)
                insigma = np.maximum(X_hpd.std(0), 1e-6)
            lb_c = np.minimum(x_best, sb.lb)
            ub_c = np.maximum(x_best, sb.ub)

            args = (_k(1), jnp.asarray(x_best, dtype=dtype),
                    jnp.asarray(insigma, dtype=dtype),
                    jnp.asarray(lb_c, dtype=dtype),
                    jnp.asarray(ub_c, dtype=dtype), vp, gp, state)
            if active_is_state is not None:
                res = _cmaes_refine_is(cfg, acq_name, *args, active_is_state,
                                       max_evals=options.search_max_fun_evals,
                                       popsize=popsize)
            else:
                res = _cmaes_refine(cfg, acq_name, *args,
                                    max_evals=options.search_max_fun_evals,
                                    popsize=popsize, smooth=smooth)
            # One device->host round trip for both values.
            f_ref, x_ref = jax.device_get((res.f_best, res.x_best))
            x_ref = np.asarray(x_ref)
            if has_int:
                from vbmc_tpu.transforms import real_to_int
                x_ref = np.asarray(real_to_int(
                    logger.trinfo, jnp.asarray(x_ref)[None, :],
                    integer_mask))[0]
                # Re-evaluate at the rounded point (rounding may change acq).
                xr = jnp.asarray(x_ref, dtype=dtype)[None, :]
                if active_is_state is not None:
                    from vbmc_tpu.active_is import evaluate_is_acquisition
                    f_ref = float(np.asarray(evaluate_is_acquisition(
                        cfg, acq_name, xr, vp, gp, state,
                        active_is_state))[0])
                else:
                    f_ref = float(np.asarray(evaluate_acquisition(
                        cfg, acq_name, xr, vp, gp, state,
                        smooth=smooth))[0])
            if float(f_ref) < f_best:
                x_best = x_ref
                f_best = float(f_ref)

        # Noisy repeated-observation logic (`activesample_vbmc.m:334-365`):
        # when acquiring at an already-observed location is (discounted)
        # better than the new candidate, re-measure the existing point —
        # exercising the precision-weighted duplicate merge in the logger.
        if repeat_obs and not fused_ok:
            if (optim_state.repeated_obs_streak
                    >= options.max_repeated_observations):
                optim_state.repeated_obs_streak = 0
            else:
                X_t, _, _ = logger.training_data()
                state_noreg = state._replace(regularize=jnp.asarray(False))
                from vbmc_tpu.utils.math import bucket_n as _bn, pad_to as _pt
                nb_t = _bn(X_t.shape[0])
                Xt_p = jnp.asarray(_pt(X_t, nb_t), dtype=dtype)
                if active_is_state is not None:
                    from vbmc_tpu.active_is import evaluate_is_acquisition
                    acq_t = evaluate_is_acquisition(cfg, acq_name, Xt_p, vp,
                                                    gp, state_noreg,
                                                    active_is_state)
                else:
                    acq_t = evaluate_acquisition(cfg, acq_name, Xt_p, vp, gp,
                                                 state_noreg, smooth=smooth)
                acq_t = np.asarray(acq_t)[:X_t.shape[0]]
                acq_t = np.where(np.isfinite(acq_t), acq_t, np.inf)
                idx_t = int(np.argmin(acq_t))
                if acq_t[idx_t] < options.repeated_acq_discount * f_best:
                    x_best = X_t[idx_t]
                    optim_state.repeated_obs_streak += 1
                else:
                    optim_state.repeated_obs_streak = 0

        y_new, _ = logger.evaluate(x_best)
        if sb.expand(x_best):
            sb_lb_dev = jnp.asarray(sb.lb, dtype=dtype)
            sb_ub_dev = jnp.asarray(sb.ub, dtype=dtype)

        # Acquisition debug record (`activesample_vbmc.m:403-409`).
        if optim_state is not None and getattr(options, "acq_debug", False):
            from vbmc_tpu.gp.predict import gp_predict_jit
            nb1 = bucket_n(1)
            xq = jnp.asarray(pad_to(np.asarray(x_best, float)[None, :], nb1),
                             dtype=dtype)
            fbar_q, vtot_q, _, _ = gp_predict_jit(cfg, gp, xq)
            optim_state.acqtable.append(
                (acq_name, float(y_new), float(np.asarray(fbar_q)[0]),
                 float(np.sqrt(max(float(np.asarray(vtot_q)[0]), 0.0)))))

        if i < n_points - 1:
            if full_update and quick_updater is not None:
                do_update = True
                if fess_thresh < 1.0:
                    # fESS gate (`activesample_vbmc.m:436-445`): skip the
                    # expensive retrain/refit while the VP still matches the
                    # refreshed GP well enough.
                    gp_tmp = gp_reupdate(cfg, gp, logger)
                    from vbmc_tpu.vpoptim import fractional_ess
                    fess = fractional_ess(jax.random.fold_in(key, 9000 + i),
                                          cfg, vp, gp_tmp, 100)
                    do_update = fess <= fess_thresh
                    if not do_update:
                        gp = gp_tmp
                if do_update:
                    # One fused async program; no blocking pull. The updated
                    # GP/VP/length-scale device arrays feed the next
                    # proposal directly.
                    gp, vp, gls_dev = quick_updater(key, logger, gp, vp)
                    vp_updated = True
                    insigma_cache = None
            else:
                gp = gp_reupdate(cfg, gp, logger)

    if vp_updated:
        # The fused updates return device-only VP/GP arrays; downstream
        # host code (candidate generation, stats, sn2hpd) reads them via
        # to_np — each unmirrored read is a blocking device->host pull.
        # ONE batched pull registers all the mirrors.
        from vbmc_tpu.utils.hostcache import register
        arrs = (vp.mu, vp.sigma, vp.lam, vp.w, vp.eta, gp.hyp, gp.hyp_mask)
        vals = jax.device_get(arrs)
        for dev, host in zip(arrs, vals):
            register(dev, np.asarray(host))

    return gp_reupdate(cfg, gp, logger), vp


def _hard_bound_eps(logger: FunctionLogger, options):
    """Original-space epsilon box used to reject near-bound candidates."""
    ti = logger.trinfo
    lb = np.asarray(ti.lb_orig)
    ub = np.asarray(ti.ub_orig)
    both = np.isfinite(lb) & np.isfinite(ub)
    width = np.where(both, ub - lb, 0.0)
    lb_eps = np.where(both, lb + width * options.tol_bound_x, -np.inf)
    ub_eps = np.where(both, ub - width * options.tol_bound_x, np.inf)
    return lb_eps, ub_eps
