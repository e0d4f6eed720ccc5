"""Probe XLA compile times of vp_rnd/moments variants on the current device."""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp

from vbmc_tpu.transforms import create_trinfo
from vbmc_tpu.vp import make_vp, vp_rnd, _moments_mc_jit
from vbmc_tpu.utils.math import mvn_kl

D, KMAX, N = 2, 32, 10 ** 5
ti = create_trinfo(np.zeros(D), np.full(D, 10.0), np.full(D, 0.05),
                   np.full(D, 3.0))
vp = make_vp(ti, np.full((3, D), 0.5), 0.3, np.ones(D), k_max=KMAX)
key = jax.random.PRNGKey(0)


def timeit(name, fn, *args):
    t0 = time.monotonic()
    lowered = jax.jit(fn).lower(*args)
    t1 = time.monotonic()
    compiled = lowered.compile()
    t2 = time.monotonic()
    print(f"{name:35s} trace={t1-t0:6.2f}s compile={t2-t1:7.2f}s")
    return compiled


# 1. current full moments path
timeit("moments_mc (current)", lambda v, k: _moments_mc_jit(v, k, N), vp, key)

# 2. without permutation
def mom_noperm(v, k):
    k_cat, k_eps, _, _ = jax.random.split(k, 4)
    logw = jnp.where(v.kmask, jnp.log(jnp.maximum(v.w, 1e-30)), -jnp.inf)
    counts = jnp.floor(v.w * N).astype(jnp.int32)
    total = jnp.sum(counts)
    extra = jax.random.categorical(k_cat, logw, shape=(N,))
    base = jnp.repeat(jnp.arange(v.k_max), counts, total_repeat_length=N)
    idx = jnp.where(jnp.arange(N) < total, base, extra)
    eps = jax.random.normal(k_eps, (N, v.D), dtype=v.mu.dtype)
    X = v.mu[idx] + v.sigma[idx][:, None] * v.lam[None, :] * eps
    from vbmc_tpu.transforms import inverse
    X = inverse(v.trinfo, X)
    mean = jnp.mean(X, axis=0)
    Xc = X - mean
    return mean, (Xc.T @ Xc) / (N - 1)
timeit("moments no-perm", mom_noperm, vp, key)

# 3. without repeat (searchsorted balanced assignment)
def mom_ss(v, k):
    k_cat, k_eps, _, _ = jax.random.split(k, 4)
    logw = jnp.where(v.kmask, jnp.log(jnp.maximum(v.w, 1e-30)), -jnp.inf)
    counts = jnp.floor(v.w * N).astype(jnp.int32)
    total = jnp.sum(counts)
    extra = jax.random.categorical(k_cat, logw, shape=(N,))
    cum = jnp.cumsum(counts)
    base = jnp.searchsorted(cum, jnp.arange(N), side="right")
    base = jnp.minimum(base, v.k_max - 1)
    idx = jnp.where(jnp.arange(N) < total, base, extra)
    eps = jax.random.normal(k_eps, (N, v.D), dtype=v.mu.dtype)
    X = v.mu[idx] + v.sigma[idx][:, None] * v.lam[None, :] * eps
    from vbmc_tpu.transforms import inverse
    X = inverse(v.trinfo, X)
    mean = jnp.mean(X, axis=0)
    Xc = X - mean
    return mean, (Xc.T @ Xc) / (N - 1)
timeit("moments searchsorted", mom_ss, vp, key)

# 4. categorical only (unbalanced)
def mom_cat(v, k):
    k_cat, k_eps = jax.random.split(k)
    logw = jnp.where(v.kmask, jnp.log(jnp.maximum(v.w, 1e-30)), -jnp.inf)
    idx = jax.random.categorical(k_cat, logw, shape=(N,))
    eps = jax.random.normal(k_eps, (N, v.D), dtype=v.mu.dtype)
    X = v.mu[idx] + v.sigma[idx][:, None] * v.lam[None, :] * eps
    from vbmc_tpu.transforms import inverse
    X = inverse(v.trinfo, X)
    mean = jnp.mean(X, axis=0)
    Xc = X - mean
    return mean, (Xc.T @ Xc) / (N - 1)
timeit("moments categorical", mom_cat, vp, key)

# 5. isolated pieces
timeit("repeat alone", lambda c: jnp.repeat(jnp.arange(KMAX), c,
                                            total_repeat_length=N),
       jnp.ones(KMAX, dtype=jnp.int32))
timeit("permutation alone", lambda k: jax.random.permutation(
    k, jnp.zeros(N, dtype=jnp.int32)), key)
timeit("categorical alone", lambda k: jax.random.categorical(
    k, jnp.zeros(KMAX), shape=(N,)), key)
timeit("gather alone", lambda i: vp.mu[i],
       jnp.zeros(N, dtype=jnp.int32))
timeit("mvn_kl alone", lambda m, c: mvn_kl(m, c, m, c),
       jnp.zeros(D), jnp.eye(D))
