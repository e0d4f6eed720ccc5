"""Bring-up check: drives `vbmc()` end to end on one NVIDIA GPU.

Phases, each printing its own lines; any failure exits non-zero:

- device: refuses anything but a GPU. Prints the JAX version, the device
  kind, the card's name and power limit (nvidia-smi, run without JAX) and
  the compile-cache directory in use.
- parity: the hot programs at the bench widths (D=6, N=256, S=16, K=16,
  M=8192) in float32 on the GPU against a float64 run of the same code on
  the CPU, in this process: GP posterior build (predictive mean and
  variance), the prospective and VIQR sweeps (values and argmin), the ELBO
  and its gradient. Each error is printed beside its tolerance. The same
  errors under "default" matmul precision (TF32 on the card) follow, as
  information only.
- e2e: `vbmc()` on bench.py's targets, float32, through bench.py's
  accuracy gate (|ELBO - lnZ| < 0.5, posterior-mean RMSE < 0.5):
  mvn6 (exact, D=6), halfnorm2_noisy (VIQR, per-point quick updates) and
  mvn10 (D=10, 300 evaluations: N passes 256 and K reaches 50). Each
  prints wall and compile seconds, iterations, evaluations, the phase
  timers and the accuracy numbers.

The last line is ``{"ok": true, "device": {...}}``.

``--four-cards`` runs only the multi-device path on four cards: the
in-loop programs (acquisition sweep, ELBO value and gradient, the fused
proposals, the quick update with GP retraining) on a GP sharded over the
mesh against the same programs unsharded, and one mvn6 `vbmc()` run with
the mesh over four cards against the same seed on one card.

Usage: python chip_smoke.py [--four-cards]
"""

import contextlib
import json
import os
import sys
import time

PARITY_SHAPES = dict(N=256, S=16, K=16, M=8192)
STRESS_EVALS = 300

# Tolerances of float32 on the card against float64 on the CPU. Errors are
# normwise: abs = max|a - b|, rel = abs / max|b|. At these widths float32
# on the CPU, at the same "highest" matmul precision, is within 3e-6 of
# float64 in every output (GP solves with noise variance 0.0025 against a
# unit output scale). The card sums in another order and factorizes with
# other routines, which changes the error but not its order: 1e-4 leaves a
# margin of ~30. Argmin: the float64 value at the card's argmin may exceed
# the float64 minimum by the same relative amount (near-ties may flip).
TOL = {name: 1e-4 for name in (
    "gp_mean", "gp_var", "acq_prospective", "acq_prospective_argmin",
    "acq_viqr", "acq_viqr_argmin", "elbo", "elbo_grad")}
# Sharded against unsharded on the same cards. The mesh changes only the
# order of the cross-device sums. In float64 every in-loop program then
# agrees to rounding times its own amplification: <= 1e-12 on four virtual
# CPU devices, including the quick update's L-BFGS MAP polish. 1e-8 leaves
# a margin of 1e4, while a wrong collective or a mis-sharded axis shows at
# 1e-2 or more. A proposal point is the minimizer of a smooth acquisition,
# which rounding fixes only to ~sqrt(eps) relative (float64: 1.7e-8 and
# 5.2e-8 on four virtual CPU devices), so the point is information and
# the check is its regret: how much worse, by the unsharded objective, the
# sharded program's point is than the unsharded program's. On four H100s
# the float64 quick update does not agree (PERF.md, Findings): that check
# fails there, and its cause is open.
TOL_SHARD64 = {name: 1e-8 for name in (
    "acq", "elbo_value", "elbo_grad", "propose_f", "propose_x_regret",
    "propose_is_f", "propose_is_x_regret", "quick_update_hyp",
    "quick_update_alpha", "quick_update_vp_mu")}
# In float32 (the bench dtype) the one-pass programs and the regrets agree
# to 1e-4 as in the parity phase. The rest are printed beside the
# unsharded program's own change under a one-ulp nudge of its
# hyperparameter samples, as information: the quick update's 8-step L-BFGS
# MAP polish turns that nudge into ~1e-2 differences (four virtual CPU
# devices: sharded and nudged both move alpha by 0.26, hyp by 0.015), and
# the proposal points move by ~sqrt(eps) = 3.5e-4 either way.
TOL_SHARD32 = {name: 1e-4 for name in (
    "acq", "elbo_value", "elbo_grad", "propose_f", "propose_x_regret",
    "propose_is_f", "propose_is_x_regret")}
# Two full runs diverge once an acquisition argmin flips, so their ELBOs
# agree only statistically: within the accuracy gate's own width.
TOL_SHARD_ELBO = 0.5


def check_device(devices):
    """The first device, which must be a GPU: a CPU result proves nothing
    about the card."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX found "
                           f"{dev.platform} ({dev.device_kind})")
    return dev


def errors(a, b) -> tuple:
    """(max abs error, normwise relative error) of ``a`` against ``b``."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)))
    return err, err / max(float(np.max(np.abs(b))), 1e-300)


def argmin_regret(a, b) -> tuple:
    """How much worse, in ``b``, the argmin of ``a`` is than b's minimum:
    (abs, relative to |min b|)."""
    import numpy as np
    b = np.asarray(b, np.float64)
    gap = float(b[int(np.argmin(a))] - np.min(b))
    return gap, gap / max(abs(float(np.min(b))), 1e-300)


def regret(f_got, f_ref) -> tuple:
    """How much worse objective value ``f_got`` is than ``f_ref``:
    (abs, relative to |f_ref|); negative when it is better."""
    gap = float(f_got) - float(f_ref)
    return gap, gap / max(abs(float(f_ref)), 1e-300)


def kernel_outputs(hp, device, x64: bool, ais_host=None):
    """Outputs of the hot programs for host problem ``hp`` on ``device``,
    in float64 when ``x64``, else float32. ``ais_host`` (numpy ISState
    fields) fixes the VIQR integration set; it is built here when None and
    returned, so both sides of a comparison sweep the same set."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import bench_kernels
    from vbmc_tpu.gp.predict import gp_predict_jit
    from vbmc_tpu.acquisitions import evaluate_acquisition
    from vbmc_tpu.active_is import (ISState, build_is_state_core,
                                    evaluate_is_acquisition)
    from vbmc_tpu import elbo as eb

    with jax.enable_x64(x64), jax.default_device(device):
        p = bench_kernels.device_problem(hp)
        cfg, gp, vp, Xs, state = (p["cfg"], p["gp"], p["vp"], p["Xs"],
                                  p["state"])
        fbar, vtot, _, _ = gp_predict_jit(cfg, gp, Xs)
        acq = evaluate_acquisition(cfg, "prospective", Xs, vp, gp, state)
        if ais_host is None:
            ais_host = jax.device_get(tuple(build_is_state_core(
                jax.random.PRNGKey(2), cfg, "viqr", vp, gp, 100, 100, 100,
                mh_steps=3)))
        ais = ISState(*(jnp.asarray(a, dtype=gp.X.dtype) for a in ais_host))
        viqr = evaluate_is_acquisition(cfg, "viqr", Xs, vp, gp, state, ais)
        flags = eb.VPFlags(opt_mu=True, opt_sigma=True, opt_lambda=True,
                           opt_weights=True)
        theta = eb.pack_theta(flags, vp.mu, vp.sigma, vp.lam,
                              jnp.log(vp.w))
        key = jax.random.PRNGKey(0)

        @jax.jit
        def elbo_step(th):
            def f(t_):
                F, _ = eb.negelcbo(cfg, t_, gp, vp.mu, vp.sigma, vp.lam,
                                   vp.w, vp.kmask, flags, 0.0, 0, 1, key)
                return F
            return jax.value_and_grad(f)(th)

        F, g = elbo_step(theta)
        out = jax.device_get(dict(gp_mean=fbar, gp_var=vtot,
                                  acq_prospective=acq, acq_viqr=viqr,
                                  elbo=F, elbo_grad=g))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}, ais_host


@contextlib.contextmanager
def no_persistent_cache():
    """Compile without the persistent compilation cache. JAX decides once
    per process whether it uses the cache, so the decision is reset on the
    way in and out. Keeps the float64 CPU reference out of the cache:
    XLA:CPU results are tied to the CPU features of the host that compiled
    them."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc
    was = jax.config.jax_enable_compilation_cache
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()


def parity(hp, device, ref_device, precision=None) -> dict:
    """Errors of the float32 run on ``device`` against the float64 run on
    ``ref_device``, as {name: (abs, rel)}. ``precision`` overrides the
    matmul precision of the float32 run."""
    import jax
    with no_persistent_cache():
        ref, ais_host = kernel_outputs(hp, ref_device, x64=True)
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        got, _ = kernel_outputs(hp, device, x64=False, ais_host=ais_host)
    errs = {k: errors(got[k], ref[k]) for k in ref}
    for name in ("acq_prospective", "acq_viqr"):
        errs[name + "_argmin"] = argmin_regret(got[name], ref[name])
    return errs


def print_errors(errs: dict, tol: dict, enforce: bool = True) -> list:
    """Print each error beside its tolerance; return the names over it.
    Names without a tolerance in ``tol`` are information only."""
    bad = []
    for name, (ab, rel) in errs.items():
        limit = tol.get(name)
        over = limit is not None and rel > limit
        bad += [name] if over and enforce else []
        verdict = (("FAIL" if over else "ok")
                   if enforce and limit is not None else "info")
        shown = f"{limit:.1e}" if limit is not None else "-"
        print(f"  {name:24s} abs={ab:.6e} rel={rel:.6e} "
              f"tol={shown} {verdict}", flush=True)
    return bad


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from
    its monitoring events since construction."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


def run_e2e(blk, seed, max_fun_evals, clock) -> dict:
    """One `vbmc()` run of a bench block, with its result printed."""
    import bench
    c0, t0 = clock.total, time.monotonic()
    r = bench.run_block(blk, seed=seed, max_fun_evals=max_fun_evals)
    r["wall_s"] = time.monotonic() - t0
    r["compile_s"] = clock.total - c0
    timers = r.get("timers", {})
    print(f"  {r['name']}: ok={r['ok']} wall_s={r['wall_s']:.3f} "
          f"compile_s={r['compile_s']:.3f} iters={r['iters']} "
          f"func_count={r['func_count']} elbo_err={r['elbo_err']:.6f} "
          f"rmse={r['rmse']:.6f}", flush=True)
    print("    timers " + " ".join(
        f"{k}={timers.get(k, float('nan')):.3f}"
        for k in ("active_sampling", "gp_train", "variational_fit",
                  "finalize", "warping")), flush=True)
    return r


def phase_device():
    import jax
    from bench_kernels import card_info
    from vbmc_tpu.main import _configure_numerics
    dev = check_device(jax.devices())
    _configure_numerics()
    print(f"[device] jax {jax.__version__}  kind={dev.device_kind}  "
          f"count={len(jax.devices())}", flush=True)
    print(f"[device] card: {card_info()}", flush=True)
    print(f"[device] compile cache: "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    return dev


def phase_parity(dev):
    import bench_kernels
    import jax
    hp = bench_kernels.host_problem(**PARITY_SHAPES)
    cpu = jax.devices("cpu")[0]
    print(f"[parity] float32 on {dev.device_kind} vs float64 on CPU, "
          f"{PARITY_SHAPES}, matmul precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    bad = print_errors(parity(hp, dev, cpu), TOL)
    print("[parity] the same under 'default' precision (TF32), "
          "information only", flush=True)
    print_errors(parity(hp, dev, cpu, precision="default"), TOL,
                 enforce=False)
    return [f"parity over tolerance: {bad}"] if bad else []


def phase_e2e(clock):
    import bench
    blocks = {b["name"]: b for b in bench._blocks()}
    print("[e2e] vbmc() runs, float32", flush=True)
    runs = [run_e2e(blocks["mvn6"], 1, 100, clock),
            run_e2e(blocks["halfnorm2_noisy"], 5, 100, clock),
            run_e2e(bench.stress_block(STRESS_EVALS), 7, STRESS_EVALS,
                    clock)]
    return [f"{r['name']} failed the gate: {r}" for r in runs if not r["ok"]]


def _use_mesh(on: bool):
    from vbmc_tpu.parallel import context
    os.environ["VBMC_SHARD"] = "auto" if on else "0"
    context.reset_mesh()
    return context.get_mesh()


def sharded_blocks(hp, ulp_witness: bool = False, n_search=8192,
                   max_evals=4000) -> dict:
    """The in-loop programs on a GP sharded over the process mesh (all
    devices) against the same programs unsharded, in JAX's current default
    dtype: {name: (abs, rel)} of sharded vs unsharded. These are the calls
    `vbmc()` makes with the mesh on: the sweep and the ELBO on
    `shard_gp(gp)`, the fused proposals, and the quick update (GP retrain
    with its MAP polish, then the VP refit) through its host wrapper.

    The proposal points also get "*_regret": their regret by the unsharded
    objective against the unsharded program's point (`regret`).

    With ``ulp_witness``, {name + "_ulp": ...} adds the unsharded programs
    with every hyperparameter sample nudged by one ulp against the same
    programs unnudged: how far rounding alone moves each output."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import bench_kernels
    from vbmc_tpu import elbo as eb
    from vbmc_tpu.acquisitions import evaluate_acquisition
    from vbmc_tpu.active_is import build_is_state_core, \
        evaluate_is_acquisition
    from vbmc_tpu.active_sample import _propose_point, _propose_point_is
    from vbmc_tpu.function_logger import FunctionLogger
    from vbmc_tpu.gp.config import GPConfig
    from vbmc_tpu.gp.fit import TrainOptions
    from vbmc_tpu.gp.gp import gp_from_host
    from vbmc_tpu.options import VBMCOptions
    from vbmc_tpu.parallel.context import shard_gp
    from vbmc_tpu.quick_update import QuickUpdater

    p = bench_kernels.device_problem(hp)
    cfg, gp, vp, Xs, state = p["cfg"], p["gp"], p["vp"], p["Xs"], p["state"]
    D, S = hp["D"], hp["S"]
    dtype = gp.X.dtype
    flags = eb.VPFlags(opt_mu=True, opt_sigma=True, opt_lambda=True,
                       opt_weights=True)
    theta = eb.pack_theta(flags, vp.mu, vp.sigma, vp.lam, jnp.log(vp.w))
    key = jax.random.PRNGKey(7)
    salt = jnp.asarray(1, dtype=jnp.int32)
    sb_lb = jnp.full((D,), -3.0, dtype=dtype)
    sb_ub = jnp.full((D,), 3.0, dtype=dtype)
    common = dict(n_search=n_search, n_heavy=n_search // 4,
                  n_mvn=n_search // 4, n_box=n_search // 4,
                  max_evals=max_evals, popsize=16)

    # A noisy-config GP (user-provided noise) for the VIQR proposal.
    cfg_n = GPConfig(D=D, user_noise=1)
    rng = np.random.default_rng(3)
    hyps_n = np.zeros((S, cfg_n.nhyp))
    hyps_n[:, :D] = np.log(0.8)
    hyps_n[:, cfg_n.ncov] = np.log(0.05)
    hyps_n[:, cfg_n.ncov + cfg_n.nnoise + 1 + D:] = np.log(1.2)
    hyps_n += 0.05 * rng.standard_normal(hyps_n.shape)
    gp_n = gp_from_host(cfg_n, hp["X"], hp["y"], np.full(hp["N"], 0.25),
                        hyps_n, n_bucket=hp["N"], s_bucket=S)

    # Training data of the quick update, as the orchestrator's log holds it.
    opt = VBMCOptions(seed=0).resolve(D)
    logger = FunctionLogger(lambda x: 0.0, D, vp.trinfo)
    for xi, yi in zip(hp["X"][:48], hp["y"][:48]):
        logger.add(xi, float(yi))
    topts = TrainOptions(ns_samples=S, ninit=0, nopts=1, thin=2,
                         n_chains=4, lbfgs_iters=8)

    @jax.jit
    def elbo_value_and_grad(th, gp_):
        def f(t):
            F, _ = eb.negelcbo(cfg, t, gp_, vp.mu, vp.sigma, vp.lam, vp.w,
                               vp.kmask, flags, 0.0, 0, 0,
                               jax.random.PRNGKey(0))
            return F
        return jax.value_and_grad(f)(th)

    def run(gp_, gp_n_):
        F, g = elbo_value_and_grad(theta, gp_)
        x_p, f_p = _propose_point(cfg, "prospective", key, salt, vp, gp_,
                                  state, sb_lb, sb_ub, smooth=False,
                                  refine=True, **common)
        x_i, f_i = _propose_point_is(cfg_n, "viqr", key, salt, vp, gp_n_,
                                     state, sb_lb, sb_ub, n_is_vp=100,
                                     n_is_box=100, n_is_mcmc=100,
                                     mh_steps=3, fess_thresh=0.5, **common)
        # A fresh updater each time: it salts its key with a call count.
        upd = QuickUpdater(cfg, opt, topts, np.full(D, -2.0),
                           np.full(D, 2.0), warmup=False,
                           entropy_switch=False, K=hp["K"], do_gp=True,
                           do_vp=True)
        gp_u, vp_u, _ = upd(jax.random.PRNGKey(11), logger, gp_, vp)
        out = dict(acq=evaluate_acquisition(cfg, "prospective", Xs, vp, gp_,
                                            state),
                   elbo_value=F, elbo_grad=g, propose_x=x_p, propose_f=f_p,
                   propose_is_x=x_i, propose_is_f=f_i,
                   quick_update_hyp=gp_u.hyp, quick_update_alpha=gp_u.alpha,
                   quick_update_vp_mu=vp_u.mu)
        return {k: np.asarray(v, np.float64)
                for k, v in jax.device_get(out).items()}

    def nudge(g):
        return g._replace(hyp=g.hyp * (1 + jnp.finfo(dtype).eps))

    assert _use_mesh(False) is None
    ref = run(gp, gp_n)
    # The unsharded objectives of the two proposals; the VIQR one with the
    # integration set its program builds from the same key.
    k_is = jax.random.split(jax.random.fold_in(key, salt), 3)[0]
    ais = jax.jit(build_is_state_core, static_argnums=(1, 2, 5, 6, 7),
                  static_argnames=("mh_steps", "fess_thresh"))(
        k_is, cfg_n, "viqr", vp, gp_n, 100, 100, 100, mh_steps=3,
        fess_thresh=0.5)
    objective = dict(
        propose_x=lambda x: evaluate_acquisition(
            cfg, "prospective", x, vp, gp, state),
        propose_is_x=lambda x: evaluate_is_acquisition(
            cfg_n, "viqr", x, vp, gp_n, state, ais))

    def compare(out):
        errs = {k: errors(out[k], ref[k]) for k in ref}
        for k, f in objective.items():
            errs[k + "_regret"] = regret(
                *jax.device_get(f(jnp.asarray(np.stack([out[k], ref[k]]),
                                              dtype))))
        return errs

    errs = {}
    if ulp_witness:
        errs = {k + "_ulp": e
                for k, e in compare(run(nudge(gp), nudge(gp_n))).items()}
    mesh = _use_mesh(True)
    got = run(shard_gp(gp, mesh), shard_gp(gp_n, mesh))
    assert mesh.devices.size == len(jax.devices())
    assert _use_mesh(False) is None
    errs.update(compare(got))
    return dict(sorted(errs.items()))


def phase_four_cards(clock):
    import jax
    import bench
    import bench_kernels
    devs = jax.devices()
    check_device(devs)
    if len(devs) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs; JAX found "
                           f"{len(devs)}")
    hp = bench_kernels.host_problem(**PARITY_SHAPES)
    print("[four-cards] in-loop programs, sharded GP vs unsharded, float64",
          flush=True)
    t0 = time.monotonic()
    with jax.enable_x64(True):
        bad = print_errors(sharded_blocks(hp), TOL_SHARD64)
    print(f"[four-cards] the same in float32 ({time.monotonic() - t0:.1f} s "
          "so far); *_ulp: the unsharded program with its hyperparameter "
          "samples nudged by one ulp", flush=True)
    bad += print_errors(sharded_blocks(hp, ulp_witness=True), TOL_SHARD32)
    failures = [f"sharded programs over tolerance: {bad}"] if bad else []

    blk = {b["name"]: b for b in bench._blocks()}["mvn6"]
    print("[four-cards] mvn6 vbmc() with the mesh over 4 cards", flush=True)
    assert _use_mesh(True).devices.size == 4
    r4 = run_e2e(blk, 1, 100, clock)
    print("[four-cards] mvn6 vbmc() on one card, same seed", flush=True)
    assert _use_mesh(False) is None
    r1 = run_e2e(blk, 1, 100, clock)
    failures += [f"{r['name']} failed the gate: {r}" for r in (r4, r1)
                 if not r["ok"]]
    d = abs(r4["elbo"] - r1["elbo"])
    print(f"[four-cards] |ELBO(4 cards) - ELBO(1 card)| = {d:.6f} "
          f"tol={TOL_SHARD_ELBO}", flush=True)
    if d > TOL_SHARD_ELBO:
        failures.append("sharded and one-card ELBOs disagree")
    return failures


def main(argv) -> int:
    four = "--four-cards" in argv
    if not four:
        # Pin to one card before JAX starts, so a machine with several
        # cards does not turn on the in-loop mesh (parallel/context.py).
        vis = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
        os.environ["CUDA_VISIBLE_DEVICES"] = vis.split(",")[0]
    import jax
    import vbmc_tpu    # noqa: F401  (fails outside a checkout)

    clock = CompileClock()
    dev = phase_device()
    if four:
        failures = phase_four_cards(clock)
    else:
        failures = phase_parity(dev) + phase_e2e(clock)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr, flush=True)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
