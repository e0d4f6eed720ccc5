"""Profile the noisy halfnorm2 block on the current backend.

Prints per-iteration phase timers and (with VBMC_PROF_LOG_COMPILES=1) every
XLA compile with its duration, to locate the wall-clock and compile-time
hot spots of the bench critical path.

Usage:  JAX_COMPILATION_CACHE_DIR=/tmp/fresh python tools/prof_noisy.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

if os.environ.get("VBMC_PROF_LOG_COMPILES", "1") == "1":
    jax.config.update("jax_log_compiles", True)
    import logging
    logging.basicConfig(level=logging.WARNING,
                        format="%(relativeCreated)9.0fms %(message)s")

from vbmc_tpu import vbmc, VBMCOptions, vp_moments

sd2 = np.array([1.0, 0.6])
noise_rng = np.random.default_rng(1)


def halfnorm_noisy(x, sd=sd2):
    y = (-0.5 * np.sum((x / sd) ** 2)
         - np.log(2 * np.pi) - np.sum(np.log(sd)))
    return float(y + noise_rng.standard_normal()), 1.0


t0 = time.monotonic()


def _progress(info):
    print(f"#    iter {info['iteration']:3d} fc={info['func_count']:3d} "
          f"elbo={info['elbo']:8.3f} K={info['K']:3d} "
          f"t={time.monotonic() - t0:7.1f}s timer={info.get('timer')}",
          flush=True)


opts = VBMCOptions(display="off", max_fun_evals=100, seed=5,
                   min_final_components=20, specify_target_noise=True,
                   output_fcn=_progress)
res = vbmc(halfnorm_noisy, x0=np.array([0.5, 0.5]), lb=np.zeros(2),
           ub=np.full(2, 10.0), plb=np.full(2, 0.05), pub=np.full(2, 3.0),
           options=opts)
elapsed = time.monotonic() - t0
mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 5)
err = abs(res.elbo - float(np.log(0.25)))
rmse = float(np.sqrt(np.mean((np.asarray(mean)
                              - sd2 * np.sqrt(2 / np.pi)) ** 2)))
print(f"# total={elapsed:.1f}s elbo_err={err:.3f} rmse={rmse:.3f} "
      f"iters={res.iterations} timers={res.timers}")
