"""Variational posterior optimization: candidate generation ("vbinit"),
the sieve (one vmapped batch of cheap ELCBO evaluations instead of the
reference's loop over 50*K candidates, cf. `misc/vpsieve_vbmc.m`),
deterministic (L-BFGS on the entropy lower bound) and stochastic (Adam on the
MC-entropy ELBO) optimization, precise re-evaluation, and weight pruning
(cf. `misc/vpoptimize_vbmc.m`).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from vbmc_tpu.gp.config import GPConfig
from vbmc_tpu.gp.gp import GP
from vbmc_tpu import elbo as eb
from vbmc_tpu.vp import VariationalPosterior, masked_softmax
from vbmc_tpu.optim import minimize_lbfgs_bounded, fminadam
from vbmc_tpu.utils.math import bucket_k, bucket_mode, bucket_pow2


def _bucket_ent(n: int) -> int:
    """Bucket per-component entropy sample counts to powers of two so jit
    caches stay small (more samples than requested is strictly better).
    In coarse bucket mode the floor is raised so the whole K schedule
    shares at most two variants — extra MC samples instead of
    recompiles."""
    if n <= 0:
        return 0
    return bucket_pow2(n, lo=64 if bucket_mode() == "coarse" else 8)


# ----------------------------------------------------------------------
# Candidate generation (cf. misc/vbinit_vbmc.m)
# ----------------------------------------------------------------------

def vbinit(rng: np.random.Generator, init_type: int, n_opts: int,
           vp: VariationalPosterior, K_new: int, k_max: int,
           X_star: np.ndarray, y_star: np.ndarray, opt_weights: bool):
    """Generate ``n_opts`` candidate parameter sets of K_new components
    (cf. `misc/vbinit_vbmc.m`; vectorized over the candidate axis — the
    reference's per-candidate loop is pure interpreter overhead and showed
    up as host-side contention when six runs share two vCPUs).

    Returns stacked host arrays: mu (n, k_max, D), sigma (n, k_max),
    lam (n, D), w (n, k_max).
    """
    from vbmc_tpu.utils.hostcache import to_np
    D = vp.D
    K_old = int(np.sum(to_np(vp.kmask)))
    mu0 = np.asarray(to_np(vp.mu))[:K_old]    # (K_old, D)
    sigma0 = np.asarray(to_np(vp.sigma))[:K_old]
    lam0 = np.asarray(to_np(vp.lam))
    w0 = np.asarray(to_np(vp.w))[:K_old]
    n_star = X_star.shape[0]
    n = n_opts

    # --- base parameter sets per strategy (n, K_new, ...) ---------------
    if init_type == 1:
        # From old variational parameters; spawn new comps near existing.
        kc = min(K_old, K_new)
        mu = np.zeros((n, K_new, D))
        sigma = np.ones((n, K_new))
        w = np.full((n, K_new), 1.0 / K_new)
        mu[:, :kc] = mu0[:kc]
        sigma[:, :kc] = sigma0[:kc]
        if opt_weights:
            w[:, :kc] = w0[:kc]
        lam = np.tile(lam0, (n, 1))
        n_grow = K_new - K_old
        if n_grow > 0:
            idx = rng.integers(K_old, size=(n, n_grow))
            mu[:, K_old:] = (mu0[idx]
                             + 0.5 * sigma0[idx][:, :, None] * lam0
                             * rng.standard_normal((n, n_grow, D)))
            sigma[:, K_old:] = sigma0[idx] * np.exp(
                0.2 * rng.standard_normal((n, n_grow)))
            if opt_weights:
                # Split weight mass from the spawning component (applied
                # sequentially per grown slot, as the reference does).
                for j in range(n_grow):
                    xi = 0.25 + 0.25 * rng.random(n)
                    src = w[np.arange(n), idx[:, j]]
                    w[:, K_old + j] = xi * src
                    w[np.arange(n), idx[:, j]] = (1 - xi) * src
        jitter = np.ones(n, dtype=bool)
        jitter[0] = False
    elif init_type == 2:
        # Highest-density training points as means.
        order = np.argsort(y_star)[::-1]
        idx_ord = np.resize(np.arange(min(K_new, n_star)), K_new)
        base_mu = X_star[order[idx_ord]]
        V = np.var(base_mu, axis=0) if K_new > 1 else np.var(X_star, axis=0)
        lam1 = X_star.std(axis=0, ddof=1) + 1e-12
        lam1 = lam1 * np.sqrt(D / np.sum(lam1 ** 2))
        mu = np.tile(base_mu, (n, 1, 1))
        sigma = np.sqrt(np.mean(V / lam1 ** 2) / K_new) * np.exp(
            0.2 * rng.standard_normal((n, K_new)))
        lam = np.tile(lam1, (n, 1))
        w = np.full((n, K_new), 1.0 / K_new)
        jitter = np.ones(n, dtype=bool)
        jitter[0] = False
    else:
        # Random training points as means.
        idx_ord = np.resize(np.arange(min(K_new, n_star)), K_new)
        orders = np.argsort(rng.random((n, n_star)), axis=1)  # n permutations
        mu = X_star[orders[:, idx_ord]]
        V = np.where(K_new > 1, np.var(mu, axis=1),
                     np.var(X_star, axis=0))                   # (n, D)
        sigma = np.sqrt(np.mean(V, axis=1, keepdims=True) / K_new) * np.exp(
            0.2 * rng.standard_normal((n, K_new)))
        lam1 = X_star.std(axis=0, ddof=1) + 1e-12
        lam1 = lam1 * np.sqrt(D / np.sum(lam1 ** 2))
        lam = np.tile(lam1, (n, 1))
        w = np.full((n, K_new), 1.0 / K_new)
        jitter = np.ones(n, dtype=bool)

    # --- common jitter block (`vbinit_vbmc.m:111-125`) ------------------
    jf = jitter.astype(float)
    mu = mu + jf[:, None, None] * sigma[:, :, None] * lam[:, None, :] * \
        rng.standard_normal((n, K_new, D))
    sigma = sigma * np.exp(0.2 * jf[:, None]
                           * rng.standard_normal((n, K_new)))
    lam = lam * np.exp(0.2 * jf[:, None] * rng.standard_normal((n, D)))
    if opt_weights:
        w = w * np.exp(0.2 * jf[:, None] * rng.standard_normal((n, K_new)))
    w = np.maximum(w, 1e-12)
    w = w / w.sum(axis=1, keepdims=True)

    mu_c = np.zeros((n, k_max, D))
    sg_c = np.ones((n, k_max))
    w_c = np.zeros((n, k_max))
    mu_c[:, :K_new] = mu
    sg_c[:, :K_new] = np.maximum(sigma, 1e-10)
    lam_c = np.maximum(lam, 1e-10)
    w_c[:, :K_new] = w
    return mu_c, sg_c, lam_c, w_c


# ----------------------------------------------------------------------
# Sieve: batched cheap ELCBO over all candidates
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "flags", "n_ent_per_k"))
def _sieve_eval(cfg: GPConfig, thetas, gp: GP, mu0, sigma0, lam0, w0, kmask,
                flags: eb.VPFlags, n_ent_per_k: int, key, bnd):
    # Per-candidate keys derived IN-TRACE (no eager split dispatch).
    keys = jax.random.split(jax.random.fold_in(key, 3), thetas.shape[0])

    def one(theta, k):
        F, _ = eb.negelcbo(cfg, theta, gp, mu0, sigma0, lam0, w0, kmask,
                           flags, 0.0, n_ent_per_k, 0, k, bnd=bnd,
                           use_bounds=True)
        return F
    return jax.vmap(one)(thetas, keys)


@partial(jax.jit, static_argnames=("cfg", "flags", "n_ent_per_k"))
def _sieve_select(cfg: GPConfig, thetas, gp: GP, mu0, sigma0, lam0, w0,
                  kmask, flags: eb.VPFlags, n_ent_per_k: int, key, bnd):
    """Sieve + in-trace argmin: returns the single best candidate theta
    (the Nslowopts=1 path — no strategy-aware start picking needed, so the
    whole selection stays on device with no host pull)."""
    keys = jax.random.split(jax.random.fold_in(key, 3), thetas.shape[0])

    def one(theta, k):
        F, _ = eb.negelcbo(cfg, theta, gp, mu0, sigma0, lam0, w0, kmask,
                           flags, 0.0, n_ent_per_k, 0, k, bnd=bnd,
                           use_bounds=True)
        return F
    nelcbo = jax.vmap(one)(thetas, keys)
    best = jnp.argmin(jnp.where(jnp.isfinite(nelcbo), nelcbo, jnp.inf))
    return thetas[best]


# ----------------------------------------------------------------------
# Full optimization
# ----------------------------------------------------------------------

class VPTemplate(NamedTuple):
    """Fixed (non-optimized) VP arrays threaded through the objective."""
    mu: jnp.ndarray
    sigma: jnp.ndarray
    lam: jnp.ndarray
    w: jnp.ndarray
    kmask: jnp.ndarray


def _thetas_np(flags, mu_c, sg_c, lam_c, w_c, kmask_np):
    """Vectorized host-side theta packing for a batch of candidates."""
    parts = []
    if flags.opt_mu:
        parts.append(mu_c.reshape(mu_c.shape[0], -1))
    if flags.opt_sigma:
        parts.append(np.log(sg_c))
    if flags.opt_lambda:
        parts.append(np.log(lam_c))
    if flags.opt_weights:
        eta = np.where(kmask_np[None, :],
                       np.log(np.maximum(w_c, 1e-30)), -40.0)
        parts.append(eta)
    return np.concatenate(parts, axis=1)


class VPOptimResult(NamedTuple):
    vp: VariationalPosterior
    elbo: float
    elbo_sd: float
    G: float
    H: float
    varss: float
    varG: float
    pruned: int
    I_sk: np.ndarray
    J_sjk: np.ndarray


def _theta_from_arrays(flags, mu, sigma, lam, w, kmask):
    eta = jnp.where(kmask, jnp.log(jnp.maximum(w, 1e-30)), -40.0)
    return eb.pack_theta(flags, jnp.asarray(mu), jnp.asarray(sigma),
                         jnp.asarray(lam), eta)


def _full_eval(cfg, theta, gp, tmpl, flags, n_fine_per_k, key):
    st = eb.elbo_stats(cfg, theta, gp, tmpl.mu, tmpl.sigma, tmpl.lam, tmpl.w,
                       tmpl.kmask, flags, n_fine_per_k, 1, key)
    return st


def vpoptimize(key, cfg: GPConfig, vp: VariationalPosterior, gp: GP,
               K_new: int, options, *, warmup: bool, entropy_switch: bool,
               n_fast_opts: int, n_slow_opts: int,
               n_ent=None, n_ent_fine=None, n_ent_fast=None,
               prune: bool = True,
               host_seed: Optional[int] = None) -> VPOptimResult:
    """Optimize the variational posterior to K_new components.

    Orchestration is host-side; every numeric batch (sieve, L-BFGS/Adam
    steps, precise ELCBO) is a jitted kernel. ``host_seed`` seeds the
    host-side candidate generation; when None it is derived from ``key``
    (one blocking device pull).
    """
    from vbmc_tpu.utils.hostcache import to_np, device_put_cached
    D = vp.D
    if host_seed is None:
        host_seed = int(jax.random.randint(jax.random.fold_in(key, 17), (),
                                           0, 2 ** 31 - 1))
    rng = np.random.default_rng(host_seed)
    k_max = bucket_k(K_new)

    opt_weights = (not warmup) and options.variable_weights
    opt_mu = options.variable_means if not warmup else True
    flags = eb.VPFlags(opt_mu=opt_mu, opt_sigma=True, opt_lambda=True,
                       opt_weights=opt_weights)

    # Entropy sample schedule.
    if n_ent is None:
        n_ent = options.evalopt("ns_ent", K_new)
    if n_ent_fine is None:
        n_ent_fine = options.evalopt("ns_ent_fine", K_new)
    if n_ent_fast is None:
        n_ent_fast = options.evalopt("ns_ent_fast", K_new)
    ns_ent_k = _bucket_ent(int(math.ceil(n_ent / K_new)))
    if entropy_switch or K_new == 1:
        ns_ent_k = 0
    ns_fine_k = _bucket_ent(int(math.ceil(n_ent_fine / K_new)))
    if entropy_switch:
        ns_fine_k = 0
    # Sieve entropy samples (`vpsieve_vbmc.m:23-33`, NSentFast; default 0
    # => the sieve uses the deterministic entropy lower bound).
    ns_fast_k = _bucket_ent(int(math.ceil(n_ent_fast / K_new)))
    if entropy_switch or K_new == 1:
        ns_fast_k = 0

    # HPD subset for candidate generation (host mirrors: no device pulls).
    from vbmc_tpu.gp.fit import get_hpd
    m = np.asarray(to_np(gp.mask), bool)
    X_all = np.asarray(to_np(gp.X))[m]
    y_all = np.asarray(to_np(gp.y))[m]
    X_hpd, y_hpd = get_hpd(X_all, y_all, options.hpd_frac)

    # Soft bounds (from training-point hull).
    bnd = eb.compute_vp_bounds(gp, options, K_new)

    # --- candidate generation + sieve --------------------------------
    theta_best_dev = None
    if n_fast_opts > 0:
        n3 = int(math.ceil(n_fast_opts / 3))
        cand = []
        types = []
        if n_slow_opts == 1:
            mu_c, sg_c, lam_c, w_c = vbinit(rng, 1, n_fast_opts, vp, K_new,
                                            k_max, X_hpd, y_hpd, opt_weights)
            cand.append((mu_c, sg_c, lam_c, w_c))
            types.append(np.ones(n_fast_opts, dtype=int))
        else:
            for t, n_t in ((1, n3), (2, n3), (3, n_fast_opts - 2 * n3)):
                if n_t <= 0:
                    continue
                arrs = vbinit(rng, t, n_t, vp, K_new, k_max, X_hpd, y_hpd,
                              opt_weights)
                cand.append(arrs)
                types.append(np.full(n_t, t, dtype=int))
        mu_c = np.concatenate([c[0] for c in cand])
        sg_c = np.concatenate([c[1] for c in cand])
        lam_c = np.concatenate([c[2] for c in cand])
        w_c = np.concatenate([c[3] for c in cand])
        types = np.concatenate(types)

        # Bucket the candidate count to a power of two (pad by repeating the
        # first candidate) so the sieve kernel compiles O(log) variants. In
        # coarse mode the sieve always runs at the full 50*k_max size: the
        # cheap-refit path (ns_elbo_incr) then shares the full path's
        # compiled kernel instead of adding shape variants of its own.
        n_c = mu_c.shape[0]
        if bucket_mode() == "coarse":
            n_pad = bucket_pow2(max(n_c, 50 * k_max))
        else:
            n_pad = bucket_pow2(n_c)
        if n_pad > n_c:
            reps = np.zeros(n_pad - n_c, dtype=int)
            mu_c = np.concatenate([mu_c, mu_c[reps]])
            sg_c = np.concatenate([sg_c, sg_c[reps]])
            lam_c = np.concatenate([lam_c, lam_c[reps]])
            w_c = np.concatenate([w_c, w_c[reps]])
            types = np.concatenate([types, np.full(n_pad - n_c, 99)])

        kmask_np = np.arange(k_max) < K_new
        kmask = jnp.asarray(kmask_np)
        dtype = gp.X.dtype
        thetas_host = _thetas_np(flags, mu_c, sg_c, lam_c, w_c, kmask_np)
        thetas = jnp.asarray(thetas_host, dtype=dtype)

        tmpl_mu = jnp.asarray(mu_c[0], dtype=dtype)
        tmpl_sigma = jnp.asarray(sg_c[0], dtype=dtype)
        tmpl_lam = jnp.asarray(lam_c[0], dtype=dtype)
        tmpl_w = jnp.asarray(w_c[0], dtype=dtype)

        # Multi-device: the sieve candidates are pure data parallelism.
        from vbmc_tpu.parallel.context import shard_rows
        thetas = shard_rows(thetas)
        # Sieve uses the *fast* entropy (0 by default => deterministic bound).
        theta_best_dev = None
        if n_slow_opts == 1:
            # Single-start path (the common steady-state case): selection
            # happens in-trace; no host pull of the sieve values.
            theta_best_dev = _sieve_select(cfg, thetas, gp, tmpl_mu,
                                           tmpl_sigma, tmpl_lam, tmpl_w,
                                           kmask, flags, ns_fast_k, key,
                                           bnd)
            thetas_np = thetas_host.astype(np.dtype(dtype), copy=False)
        else:
            nelcbo = np.asarray(_sieve_eval(cfg, thetas, gp, tmpl_mu,
                                            tmpl_sigma, tmpl_lam, tmpl_w,
                                            kmask, flags, ns_fast_k, key,
                                            bnd))
            nelcbo = np.where(np.isfinite(nelcbo), nelcbo, np.inf)
            order = np.argsort(nelcbo)
            # Host copy of the candidate thetas (cast to the device dtype so
            # the values match a device pull bit-for-bit).
            thetas_np = thetas_host.astype(np.dtype(dtype), copy=False)[order]
            types = types[order]
    else:
        kmask_np = np.arange(k_max) < K_new
        kmask = jnp.asarray(kmask_np)
        dtype = gp.X.dtype
        # Repad current vp to k_max (host math + host theta packing).
        mu_p = np.zeros((k_max, D)); sg_p = np.ones(k_max)
        w_p = np.zeros(k_max)
        K_old = int(np.sum(to_np(vp.kmask)))
        mu_p[:K_old] = np.asarray(to_np(vp.mu))[:K_old]
        sg_p[:K_old] = np.asarray(to_np(vp.sigma))[:K_old]
        w_p[:K_old] = np.asarray(to_np(vp.w))[:K_old]
        lam_np = np.asarray(to_np(vp.lam))
        th = _thetas_np(flags, mu_p[None], sg_p[None], lam_np[None],
                        w_p[None], kmask_np)[0]
        thetas_np = th.astype(np.dtype(dtype))[None, :]
        types = np.array([1])
        tmpl_mu = jnp.asarray(mu_p, dtype=dtype)
        tmpl_sigma = jnp.asarray(sg_p, dtype=dtype)
        tmpl_lam = jnp.asarray(lam_np, dtype=dtype)
        tmpl_w = jnp.asarray(w_p, dtype=dtype)

    tmpl = VPTemplate(tmpl_mu, tmpl_sigma, tmpl_lam, tmpl_w, kmask)

    # --- pick starts per strategy and run slow optimizations ----------
    results = []  # (theta, stats dict)
    taken = np.zeros(len(types), dtype=bool)

    def pick_start(i_opt):
        if n_slow_opts == 1:
            want = None
        elif n_slow_opts == 2:
            want = [1] if i_opt == 0 else [2, 3]
        else:
            want = [((i_opt) % 3) + 1]
        for j in range(len(types)):
            if taken[j]:
                continue
            if want is None or types[j] in want:
                taken[j] = True
                return thetas_np[j]
        for j in range(len(types)):
            if not taken[j]:
                taken[j] = True
                return thetas_np[j]
        return thetas_np[0]

    elcbo_beta = options.elcbo_weight
    n_opts = max(n_slow_opts, 1)
    # Pad the start batch to a bucket (repeat the first start) so the
    # vmapped optimizer compiles ONE variant per theta size, not one per
    # batch size — a per-variant remote compile costs more than the padded
    # rows' device time.
    n_opts_b = bucket_pow2(n_opts, lo=2 if bucket_mode() == "coarse" else 1)
    if n_fast_opts > 0 and theta_best_dev is not None:
        # Device-selected best start, replicated to the padded batch (same
        # semantics as pick_start at Nslowopts=1: best candidate + repeats).
        theta0s = jnp.tile(theta_best_dev[None, :], (n_opts_b, 1))
    else:
        starts_list = [pick_start(i) for i in range(n_opts)]
        starts_list += [starts_list[0]] * (n_opts_b - n_opts)
        theta0s = jnp.asarray(np.stack(starts_list))

    # Slow optimization + midpoint selection + precise ELCBO re-evaluation
    # run as ONE device program per path (L-BFGS / Adam): the optimizer
    # traces never cross to the host, and the single blocking pull below
    # collects the full stats dict of every candidate. The precise-eval
    # batch is padded to a power of two inside the program (repeat row 0)
    # so the 1-start and 2-start paths share one compiled variant.
    n_mid = (2 * n_opts_b if (ns_ent_k > 0 and options.elcbo_midpoint)
             else n_opts_b)
    n_mid_b = bucket_pow2(n_mid, lo=4 if bucket_mode() == "coarse" else 1)
    if ns_ent_k == 0:
        sts_dev, mids_dev = _lbfgs_eval_batch(
            cfg, flags, theta0s, gp, tmpl, elcbo_beta, bnd, key,
            options.lbfgs_iters, ns_fine_k, n_mid_b)
    else:
        step_min = min(options.sgd_step_size, 0.001)
        if warmup or not opt_weights:
            step_max = min(0.1, options.sgd_step_size * 10)
        else:
            step_max = min(0.1, options.sgd_step_size)
        step_max = max(step_min, step_max)
        sts_dev, mids_dev = _adam_eval_batch(
            cfg, flags, theta0s, gp, tmpl, elcbo_beta, bnd, key, ns_ent_k,
            int(min(options.max_iter_stochastic, 10000)), step_min, step_max,
            options.tol_fun_stochastic, bool(options.elcbo_midpoint),
            ns_fine_k, n_mid_b)
    sts, mids_np = jax.device_get((sts_dev, mids_dev))
    for j in range(mids_np.shape[0]):
        results.append((mids_np[j],
                        {kk: vv[j] for kk, vv in sts.items()}))

    # --- select best by ELCBO ---------------------------------------
    beta_sel = options.elcbo_impro_weight * 0.0  # selection uses nelcbo below
    nelcbo_vals = []
    for th, st in results:
        nelbo = -float(st["elbo"])
        nelcbo_vals.append(nelbo + elcbo_beta * math.sqrt(max(float(st["varF"]), 0.0)))
    best = int(np.argmin(nelcbo_vals))
    theta_best, st_best = results[best]

    # --- pruning ------------------------------------------------------
    pruned = 0
    kmask_np = kmask_np.copy()
    w_cur = np.asarray(st_best["w"])
    mu_cur = np.asarray(st_best["mu"])
    sg_cur = np.asarray(st_best["sigma"])
    lam_cur = np.asarray(st_best["lam"])
    elbo_cur = float(st_best["elbo"])
    elbo_sd_cur = math.sqrt(max(float(st_best["varF"]), 0.0))
    st_cur = st_best

    if prune and opt_weights:
        threshold_mult = options.evalopt("pruning_threshold_multiplier", K_new)
        pruning_threshold = options.tol_improvement * threshold_mult
        checked = np.zeros(k_max, dtype=bool)
        # All candidate single-component removals are evaluated as ONE
        # vmapped batch per round (padded to a fixed width so the kernel
        # compiles once); the least-damaging removal below threshold is
        # committed and the loop repeats against the new baseline. Same
        # greedy one-at-a-time semantics as `vpoptimize_vbmc.m:156-186`,
        # at ~1 device dispatch per accepted prune instead of one per try.
        P = 8
        while True:
            small = np.where((w_cur < options.tol_weight) & kmask_np
                             & ~checked)[0]
            if small.size == 0 or kmask_np.sum() <= 1:
                break
            cand = small[:P]
            idxs = np.resize(cand, P)
            # Whole stats dict pulled in one blocking transfer; per-removal
            # keys derived in-trace from (key, idx, position).
            sts_p = jax.device_get(_prune_eval_batch(
                cfg, gp, jnp.asarray(mu_cur), jnp.asarray(sg_cur),
                jnp.asarray(lam_cur), jnp.asarray(w_cur),
                jnp.asarray(kmask_np), jnp.asarray(idxs, dtype=jnp.int32),
                flags, ns_fine_k, key))
            elbos_p, varFs_p = sts_p["elbo"], sts_p["varF"]
            n_c = len(cand)
            sds_p = np.sqrt(np.maximum(varFs_p[:n_c], 0.0))
            d_elcbo = np.abs(
                (elbos_p[:n_c] - options.elcbo_impro_weight * sds_p)
                - (elbo_cur - options.elcbo_impro_weight * elbo_sd_cur))
            ok = d_elcbo < pruning_threshold
            if not ok.any():
                checked[cand] = True
                continue
            j = int(np.argmin(np.where(ok, d_elcbo, np.inf)))
            idx = int(cand[j])
            kmask_np[idx] = False
            st_cur = {kk: vv[j] for kk, vv in sts_p.items()}
            w_cur = np.asarray(st_cur["w"])
            elbo_cur, elbo_sd_cur = float(elbos_p[j]), float(sds_p[j])
            pruned += 1

    # All st_cur values are host numpy (batched device_get above); the VP
    # device arrays register host mirrors so the next iteration's candidate
    # generation reads them back for free.
    vp_new = VariationalPosterior(
        w=device_put_cached(
            w_cur * kmask_np / max((w_cur * kmask_np).sum(), 1e-30),
            dtype=gp.X.dtype),
        eta=device_put_cached(np.where(kmask_np,
                                       np.log(np.maximum(w_cur, 1e-30)),
                                       -40.0), dtype=gp.X.dtype),
        mu=device_put_cached(np.asarray(st_cur["mu"]), dtype=gp.X.dtype),
        sigma=device_put_cached(np.asarray(st_cur["sigma"]),
                                dtype=gp.X.dtype),
        lam=device_put_cached(np.asarray(st_cur["lam"]), dtype=gp.X.dtype),
        kmask=device_put_cached(kmask_np),
        trinfo=vp.trinfo)

    return VPOptimResult(
        vp=vp_new, elbo=elbo_cur, elbo_sd=elbo_sd_cur,
        G=float(st_cur["G"]), H=float(st_cur["H"]),
        varss=float(st_cur["varss"]), varG=float(st_cur["varF"]),
        pruned=pruned, I_sk=np.asarray(st_cur["I_sk"]),
        J_sjk=np.asarray(st_cur["J_sjk"]))


def vp_sample_theta(key, cfg: GPConfig, vp: VariationalPosterior, gp: GP,
                    n_samples: int, options, *, sampler: Optional[str] = None,
                    scale_lower_bound: bool = True):
    """MCMC sampling of the variational parameters under the ELBO as a log
    density (cf. `misc/vpsample_vbmc.m`; experimental
    `active_variational_samples` path). Returns an updated VP drawn from the
    chain end. ``sampler`` defaults to ``options.variational_sampler``."""
    from vbmc_tpu.samplers.mala import mala_sample
    from vbmc_tpu.samplers.slice import slice_sample_chain

    if sampler is None:
        sampler = {"malasample": "mala", "mala": "mala",
                   "slicesample": "slice", "slice": "slice"}.get(
            getattr(options, "variational_sampler", "malasample"), "mala")

    K_max = vp.k_max
    D = vp.D
    flags = eb.VPFlags(opt_mu=True, opt_sigma=True, opt_lambda=True,
                       opt_weights=False)
    theta0 = eb.pack_theta(flags, vp.mu, vp.sigma, vp.lam, vp.eta)
    bnd = eb.compute_vp_bounds(gp, options, int(jnp.sum(vp.kmask)))

    def logp(th):
        F, _ = eb.negelcbo(cfg, th, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                           vp.kmask, flags, 0.0, 0, 0, key, bnd=bnd,
                           use_bounds=True)
        return -F

    if sampler == "mala":
        def lp_grad(th):
            return jax.value_and_grad(logp)(th)
        samples, _, _ = mala_sample(key, lp_grad, theta0, n_samples,
                                    step0=0.01)
        theta_new = samples[-1]
    else:
        n = theta0.shape[0]
        widths = 0.1 * jnp.ones(n, dtype=theta0.dtype)
        lo = jnp.full(n, -jnp.inf, dtype=theta0.dtype)
        hi = jnp.full(n, jnp.inf, dtype=theta0.dtype)
        buf, _ = slice_sample_chain(key, logp, theta0, widths, lo, hi,
                                    jnp.asarray(n_samples), jnp.asarray(0),
                                    jnp.asarray(1), max(n_samples, 1))
        theta_new = buf[n_samples - 1]

    mu, sigma, lam, w = eb.unpack_theta(flags, theta_new, K_max, D, vp.mu,
                                        vp.sigma, vp.lam, vp.w, vp.kmask)
    return vp._replace(mu=mu, sigma=sigma, lam=lam)


@partial(jax.jit, static_argnames=("cfg", "n_samples"))
def _fess_jit(key, cfg: GPConfig, vp, gp, n_samples: int):
    from vbmc_tpu.vp import vp_rnd, vp_log_pdf_trans
    from vbmc_tpu.gp.predict import gp_predict

    Xs = vp_rnd(vp, key, n_samples, orig_flag=False, balance_flag=True,
                permute=False)
    fbar, _, _, _ = gp_predict(cfg, gp, Xs)
    logq = vp_log_pdf_trans(vp, Xs)
    lnw = fbar - logq
    lnw = lnw - jax.scipy.special.logsumexp(lnw)
    return 1.0 / jnp.sum(jnp.exp(2.0 * lnw)) / n_samples


def fractional_ess(key, cfg: GPConfig, vp: VariationalPosterior, gp: GP,
                   n_samples: int = 100) -> float:
    """Fractional effective sample size of the VP against the GP posterior
    mean density (cf. `misc/fess_vbmc.m`). One device program + one pull."""
    return float(_fess_jit(key, cfg, vp, gp, n_samples))


# ----------------------------------------------------------------------
# Optimizer drivers (traced inline by the fused jitted programs below)
# ----------------------------------------------------------------------

def _lbfgs_batch_core(cfg, flags, theta0s, gp, tmpl, beta, bnd, keys,
                      maxiter):
    """All slow-optimization starts as ONE vmapped L-BFGS batch."""
    def run(th0, k):
        def obj(th):
            F, _ = eb.negelcbo(cfg, th, gp, tmpl.mu, tmpl.sigma, tmpl.lam,
                               tmpl.w, tmpl.kmask, flags, beta, 0, 0, k,
                               bnd=bnd, use_bounds=True)
            return F
        lb = jnp.full(th0.shape, -jnp.inf, dtype=th0.dtype)
        ub = jnp.full(th0.shape, jnp.inf, dtype=th0.dtype)
        return minimize_lbfgs_bounded(obj, th0, lb, ub, maxiter=maxiter)
    return jax.vmap(run)(theta0s, keys)


def _adam_batch_core(cfg, flags, theta0s, gp, tmpl, beta, bnd, keys,
                     ns_ent_k, maxiter, step_min, step_max, tol_fun):
    def run(th0, k):
        def f_vg(th, kk):
            def f(t):
                F, _ = eb.negelcbo(cfg, t, gp, tmpl.mu, tmpl.sigma,
                                   tmpl.lam, tmpl.w, tmpl.kmask, flags,
                                   beta, ns_ent_k, 0, kk, bnd=bnd,
                                   use_bounds=True)
                return F
            return jax.value_and_grad(f)(th)
        return fminadam(f_vg, th0, tol_fun=tol_fun, maxiter=maxiter,
                        step_min=step_min, step_max=step_max, key=k)
    return jax.vmap(run)(theta0s, keys)


def _pad_rows(x, n_out: int):
    """Pad axis 0 to ``n_out`` by repeating row 0 (device-side)."""
    n = x.shape[0]
    if n >= n_out:
        return x[:n_out]
    return jnp.concatenate([x, jnp.tile(x[:1], (n_out - n,) + (1,) *
                                        (x.ndim - 1))])


def _start_keys(key, n: int):
    """Per-start keys (fold_in(key, 100+i)) derived in-trace."""
    return jax.vmap(lambda i: jax.random.fold_in(key, 100 + i))(
        jnp.arange(n))


@partial(jax.jit, static_argnames=("cfg", "flags", "maxiter", "ns_fine_k",
                                   "n_out"))
def _lbfgs_eval_batch(cfg, flags, theta0s, gp, tmpl, beta, bnd, key,
                      maxiter, ns_fine_k, n_out: int):
    """Deterministic slow path fused end to end: vmapped L-BFGS over all
    starts, pad to the precise-eval bucket, full ELCBO stats — ONE device
    program, one host pull at the call site."""
    keys = _start_keys(key, theta0s.shape[0])
    thetas_opt, _ = _lbfgs_batch_core(cfg, flags, theta0s, gp, tmpl, beta,
                                      bnd, keys, maxiter)
    mids = _pad_rows(thetas_opt, n_out)
    evalkeys = jax.vmap(lambda k: jax.random.fold_in(k, 7))(
        _pad_rows(keys, n_out))
    sts = _full_eval_core(cfg, mids, gp, tmpl, flags, ns_fine_k, evalkeys)
    return sts, mids


@partial(jax.jit, static_argnames=("cfg", "flags", "ns_ent_k", "maxiter",
                                   "use_midpoint", "ns_fine_k", "n_out"))
def _adam_eval_batch(cfg, flags, theta0s, gp, tmpl, beta, bnd, key,
                     ns_ent_k, maxiter, step_min, step_max, tol_fun,
                     use_midpoint: bool, ns_fine_k, n_out: int):
    """Stochastic slow path fused end to end: vmapped Adam, on-device
    midpoint selection (`vpoptimize_vbmc.m:103-136` ELCBO-midpoint), pad,
    precise ELCBO stats. The optimizer traces never reach the host."""
    keys = _start_keys(key, theta0s.shape[0])
    res = _adam_batch_core(cfg, flags, theta0s, gp, tmpl, beta, bnd, keys,
                           ns_ent_k, maxiter, step_min, step_max, tol_fun)
    if use_midpoint:
        T = res.f_trace.shape[1]

        def midpoint(xtr, ftr, n_it):
            masked = jnp.where(jnp.arange(T) < n_it, ftr, jnp.inf)
            return xtr[jnp.argmin(masked)]

        xmid = jax.vmap(midpoint)(res.x_trace, res.f_trace, res.n_iters)
        # Interleave [mid_i, final_i] to preserve the candidate ordering.
        mids = jnp.stack([xmid, res.x], axis=1).reshape(
            -1, res.x.shape[-1])
        keys2 = jnp.repeat(keys, 2, axis=0)
    else:
        mids = res.x
        keys2 = keys
    mids = _pad_rows(mids, n_out)
    evalkeys = jax.vmap(lambda k: jax.random.fold_in(k, 7))(
        _pad_rows(keys2, n_out))
    sts = _full_eval_core(cfg, mids, gp, tmpl, flags, ns_fine_k, evalkeys)
    return sts, mids


@partial(jax.jit, static_argnames=("cfg", "flags", "ns_fine_k"))
def _prune_eval_batch(cfg, gp, mu, sigma, lam, w, kmask, idxs, flags,
                      ns_fine_k, key):
    """ELBO stats for a batch of candidate single-component removals."""
    def one(idx, j):
        k = jax.random.fold_in(key, 999 + idx + 31 * j)
        kmask_try = kmask & (jnp.arange(kmask.shape[0]) != idx)
        w_try = w * kmask_try.astype(w.dtype)
        w_try = w_try / jnp.maximum(w_try.sum(), 1e-30)
        th = _theta_from_arrays(flags, mu, sigma, lam, w_try, kmask_try)
        return eb.elbo_stats(cfg, th, gp, mu, sigma, lam, w_try, kmask_try,
                             flags, ns_fine_k, 1, k)
    return jax.vmap(one)(idxs, jnp.arange(idxs.shape[0]))


def _full_eval_core(cfg, thetas, gp, tmpl, flags, ns_fine_k, keys):
    def one(th, k):
        return eb.elbo_stats(cfg, th, gp, tmpl.mu, tmpl.sigma, tmpl.lam,
                             tmpl.w, tmpl.kmask, flags, ns_fine_k, 1, k)
    return jax.vmap(one)(thetas, keys)
