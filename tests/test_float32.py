"""float32 lane: the GPU bench runs in f32 (x64 off), but the main suite
forces x64 (conftest). These tests run the f32 path in a SUBPROCESS (jax
x64 is process-global) covering: a reduced exact end-to-end run, the
BQ-variance cancellation path (`gplogjoint_J` = prior_term - data_term, the
quantity reduced-precision (TF32) matmuls corrupt — main.py
`_configure_numerics`), and the
1e-30-not-1e-300 guard floor that only exists in f32."""

import json
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import sys, json
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
# x64 NOT enabled: this is the f32 lane (the GPU bench configuration).
import numpy as np
assert jax.numpy.zeros(1).dtype == jax.numpy.float32

out = {}

# --- BQ variance cancellation path in f32 -------------------------------
from vbmc_tpu.gp.config import GPConfig, MEAN_NEGQUAD
from vbmc_tpu.gp.gp import gp_from_host
from vbmc_tpu.elbo import gplogjoint

rng = np.random.default_rng(0)
D, N, K = 2, 24, 3
X = rng.standard_normal((N, D))
y = -0.5 * np.sum(X ** 2, 1)
nhyp = D + 1 + 1 + 1 + 2 * D
hyp = np.tile(np.concatenate([
    np.zeros(D), [0.0], [np.log(1e-2)], [0.5], np.zeros(D),
    np.zeros(D)]), (3, 1)) + 0.05 * rng.standard_normal((3, nhyp))
cfg = GPConfig(D=D, meanfun=MEAN_NEGQUAD, const_noise=1)
gp = gp_from_host(cfg, X, y, None, hyp, n_bucket=32, s_bucket=4)
mu = rng.standard_normal((K, D)).astype(np.float32)
sigma = np.full(K, 0.5, np.float32)
lam = np.ones(D, np.float32)
w = np.full(K, 1.0 / K, np.float32)
kmask = np.ones(K, bool)
G, varG, varss, I, J = gplogjoint(cfg, gp, mu, sigma, lam, w, kmask,
                                  compute_var=1)
out["G"] = float(G)
out["varG"] = float(varG)
# The posterior covariance of the integral must be PSD-ish and finite in
# f32: the J_jk = prior - data cancellation must not go negative beyond
# the guard floor.
Jd = np.asarray(J)
out["J_finite"] = bool(np.all(np.isfinite(Jd[:1])))
out["varG_nonneg"] = bool(varG >= 0.0)

# --- reduced exact end-to-end run in f32 --------------------------------
from vbmc_tpu import vbmc, VBMCOptions, vp_moments
sd = np.array([1.0, 0.8])
def logp(x):
    return float(-0.5 * np.sum((x / sd) ** 2) - np.log(2 * np.pi)
                 - np.sum(np.log(sd)))
opts = VBMCOptions(display="off", max_fun_evals=28, seed=1,
                   min_final_components=8)
res = vbmc(logp, x0=np.zeros(2), plb=np.full(2, -3.0), pub=np.full(2, 3.0),
           options=opts)
mean, _ = vp_moments(res.vp, orig_flag=True, n_samples=10 ** 4)
out["elbo_err"] = abs(res.elbo - 0.0)
out["rmse"] = float(np.sqrt(np.mean(np.asarray(mean) ** 2)))
out["dtype_ok"] = str(res.vp.mu.dtype) == "float32"
print("F32RESULT " + json.dumps(out))
"""


def test_float32_lane():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # single CPU device; keep the run small
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"repo": repo}],
        capture_output=True, text=True, timeout=1500, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines()
            if l.startswith("F32RESULT ")][-1]
    out = json.loads(line[len("F32RESULT "):])
    assert out["dtype_ok"]
    assert out["J_finite"] and out["varG_nonneg"]
    # Statistical acceptance with the f32-appropriate budget.
    assert out["elbo_err"] < 0.6, out
    assert out["rmse"] < 0.5, out
