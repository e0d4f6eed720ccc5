"""Microbenchmarks of the VBMC hot kernels on the current GPU.

Reports per-kernel time and achieved FLOP rates for:
  1. batched GP posterior build (S Cholesky factorizations + inverses)
  2. the 2^13-candidate acquisition sweep (GEMM-shaped predict + mixture pdf)
  3. the VIQR importance-sampling sweep (the noisy-path hot kernel)
  4. one ELBO value-and-gradient step (Bayesian quadrature + entropy)
  5. one GP hyperparameter slice-sampling / ensemble sweep

Each row's time is the median over repeats of one call ended by
`block_until_ready` (host clock). Rates are compared with the published
peaks of the card (`PEAKS`); a device missing from that table is an error.
The rows run at the matmul precision `vbmc()` sets ("highest": true
float32, no TF32), so `frac_fp32_peak` is the share that matters.

Usage: python bench_kernels.py [N] [S] [K] [M]
Prints the card's name and power limit, then one JSON line per kernel.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# Published dense peaks of one card, keyed by `device_kind` prefix:
# TFLOP/s per dtype path and device-memory bandwidth in TB/s. Source:
# NVIDIA H100 Tensor Core GPU data sheet (SXM part, dense, no sparsity;
# full 700 W power limit).
PEAKS = {
    "NVIDIA H100": {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                    "fp32_tflops": 67.0, "hbm_tbps": 3.35,
                    "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM)"},
}


def peak_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; raises for an unknown device."""
    for prefix, peaks in PEAKS.items():
        if device_kind.startswith(prefix):
            return peaks
    raise KeyError(f"no published peaks for device {device_kind!r}; "
                   f"add it to bench_kernels.PEAKS with its source")


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_call(fn, reps: int = 10) -> float:
    """Median seconds of ``fn(i)`` ended by block_until_ready (after one
    warm-up call). ``fn`` perturbs an input by ``i`` so no two calls are
    the same computation."""
    import jax
    jax.block_until_ready(fn(0))
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def host_problem(N=256, S=16, K=16, M=8192, D=6, seed=0) -> dict:
    """Host-side (numpy) inputs of the hot kernels at the bench shapes:
    a D-dim quadratic log density on N points, S hyperparameter samples,
    a K-component VP and M candidates."""
    from vbmc_tpu.gp.config import GPConfig
    rng = np.random.default_rng(seed)
    cfg = GPConfig(D=D)
    X = rng.uniform(-2, 2, (N, D))
    hyps = np.zeros((S, cfg.nhyp))
    hyps[:, :D] = np.log(0.8)
    hyps[:, cfg.ncov] = np.log(0.05)
    hyps[:, cfg.ncov + cfg.nnoise + 1 + D:] = np.log(1.2)
    hyps += 0.03 * rng.standard_normal(hyps.shape)
    return dict(cfg=cfg, N=N, S=S, K=K, M=M, D=D, X=X,
                y=-0.5 * np.sum(X ** 2, 1), hyps=hyps,
                mu=rng.uniform(-1, 1, (K, D)),
                Xs=rng.uniform(-2, 2, (M, D)))


def device_problem(hp: dict) -> dict:
    """Device arrays of ``hp`` in JAX's current default dtype and device,
    with the GP posterior built by the jitted build (`_build_gp_jit`)."""
    import jax.numpy as jnp
    from vbmc_tpu.gp.fit import _build_gp_jit
    from vbmc_tpu.acquisitions import AcqState
    from vbmc_tpu.vp import make_vp
    from vbmc_tpu.transforms import create_trinfo

    cfg, D = hp["cfg"], hp["D"]
    dtype = jnp.zeros(0).dtype
    arr = lambda a: jnp.asarray(a, dtype=dtype)
    N = hp["N"]
    build_args = (arr(hp["X"]), arr(hp["y"]), arr(np.zeros(N)),
                  jnp.ones(N, dtype=bool), arr(hp["hyps"]),
                  jnp.ones(hp["S"], dtype=bool))
    gp = _build_gp_jit(cfg, *build_args)
    trinfo = create_trinfo([-np.inf] * D, [np.inf] * D, [-2.0] * D,
                           [2.0] * D)
    vp = make_vp(trinfo, hp["mu"], 0.5, np.ones(D))
    state = AcqState(
        ymax=arr(0.0), tol_var=arr(1e-4),
        lb_eps_orig=jnp.full((D,), -jnp.inf, dtype=dtype),
        ub_eps_orig=jnp.full((D,), jnp.inf, dtype=dtype),
        gp_length_scale=jnp.ones(D, dtype=dtype),
        var_log_joint=jnp.ones(hp["S"], dtype=dtype),
        regularize=jnp.asarray(True))
    return dict(cfg=cfg, gp=gp, build_args=build_args, vp=vp,
                Xs=arr(hp["Xs"]), state=state)


def main():
    import jax
    import jax.numpy as jnp
    from vbmc_tpu.main import _configure_numerics
    _configure_numerics()
    from vbmc_tpu.gp.fit import _build_gp_jit
    from vbmc_tpu.acquisitions import evaluate_acquisition
    from vbmc_tpu.active_is import build_is_state_core, \
        evaluate_is_acquisition
    from vbmc_tpu import elbo as eb

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_kernels measures a GPU; found "
                         f"{dev.platform} ({dev.device_kind})")
    kind = dev.device_kind
    peaks = peak_for(kind)
    print(f"# card: {card_info()}", flush=True)

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    M = int(sys.argv[4]) if len(sys.argv) > 4 else 8192
    hp = host_problem(N, S, K, M)
    p = device_problem(hp)
    cfg, gp, vp, Xs, state = p["cfg"], p["gp"], p["vp"], p["Xs"], p["state"]
    D = hp["D"]
    dtype = gp.X.dtype
    precision = str(jax.config.jax_default_matmul_precision)
    results = []

    # 1. posterior build: S x (chol(N,N) + inverse) ~ S * (N^3/3 + N^3)
    X_, y_, s2_, m_, h_, hm_ = p["build_args"]
    results.append(("gp_posterior_build",
                    lambda i: _build_gp_jit(cfg, X_, y_, s2_, m_,
                                            h_ + i * 1e-6, hm_),
                    S * (N ** 3 / 3 + N ** 3 + 2 * N ** 2 * D)))

    # 2. acquisition sweep: per sample kernel cross N*M*D, Binv@ks N*N*M,
    # products 2*N*M
    results.append(("acquisition_sweep_8k",
                    lambda i: evaluate_acquisition(cfg, "prospective",
                                                   Xs + i * 1e-6, vp, gp,
                                                   state),
                    S * (2 * N * M * D + 2 * N * N * M + 4 * N * M)
                    + 2 * K * M * D))

    # 3. VIQR sweep: per sample kma (M,Na), kmx (M,N), kmx @ invK
    # (M,N)x(N,Na), variance reduction + sinh + logsumexp over Na.
    ais = build_is_state_core(jax.random.PRNGKey(2), cfg, "viqr", vp, gp,
                              100, 100, 100, mh_steps=3)
    Na = ais.Xa.shape[0]
    results.append(("viqr_sweep_8k",
                    lambda i: evaluate_is_acquisition(cfg, "viqr",
                                                      Xs + i * 1e-6, vp, gp,
                                                      state, ais),
                    S * (2 * N * M * D + 2 * M * Na * D + 2 * M * N * Na
                         + 6 * M * Na)))

    # 4. ELBO value+grad: z matrix 2x(S,K,N) einsums over D + J data term
    # 2 GEMMs (S,K,N)x(N,N)
    flags = eb.VPFlags(opt_weights=True)
    theta = eb.pack_theta(flags, vp.mu, vp.sigma, vp.lam,
                          jnp.zeros(K, dtype=dtype))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def elbo_step(th):
        def f(t_):
            F, _ = eb.negelcbo(cfg, t_, gp, vp.mu, vp.sigma, vp.lam, vp.w,
                               vp.kmask, flags, 0.0, 0, 1, key)
            return F
        return jax.value_and_grad(f)(th)

    results.append(("elbo_value_and_grad",
                    lambda i: elbo_step(theta + i * 1e-6),
                    2 * (S * (4 * K * N * D)
                         + S * (2 * K * N * N + 2 * K * K * N))))

    # 5. one slice-sampling sweep over all hyperparameters (~4 nlZ evals
    # per coordinate), and one ensemble sweep (2 half-moves x ~4 batched
    # shrink evals, each a (S/2, N, N) Cholesky).
    from vbmc_tpu.gp import core as gcore
    from vbmc_tpu.samplers.slice import _slice_sweep
    from vbmc_tpu.samplers.ensemble import ensemble_slice_final
    walkers0 = jnp.asarray(hp["hyps"], dtype=dtype)

    def logp(hh):
        return -gcore.neg_log_marginal_likelihood(cfg, hh, gp.X, gp.y,
                                                  gp.s2, gp.mask)

    @jax.jit
    def sweep(h):
        return _slice_sweep(jax.random.PRNGKey(1), logp, h, logp(h),
                            jnp.ones_like(h), h - 10.0, h + 10.0)

    @jax.jit
    def esweep(w0):
        xs, _ = ensemble_slice_final(jax.random.PRNGKey(3), logp, w0,
                                     walkers0.min(0) - 10.0,
                                     walkers0.max(0) + 10.0, 1)
        return xs

    results.append(("slice_sweep_nlz",
                    lambda i: sweep(walkers0[0] + i * 1e-6),
                    cfg.nhyp * 4 * (N ** 3 / 3)))
    results.append(("ensemble_sweep_nlz",
                    lambda i: esweep(walkers0 + i * 1e-6),
                    2 * 4 * (S // 2) * (N ** 3 / 3)))

    for name, fn, flops in results:
        t = time_call(fn)
        tflops = flops / t / 1e12
        row = {"metric": f"kernel_{name}_ms", "value": t * 1e3, "unit": "ms",
               "flops": int(flops), "tflops": tflops,
               "frac_fp32_peak": tflops / peaks["fp32_tflops"],
               "dtype": str(dtype), "precision": precision,
               "device": kind, "platform": dev.platform,
               "N": N, "S": S, "K": K, "M": M}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
