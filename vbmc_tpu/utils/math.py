"""Small numeric helpers shared across the package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sq_dist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All pairwise squared distances between rows of a (n,D) and b (m,D).

    Matmul formulation: one (n,m) matmul plus rank-1 row/col norms
    (cf. `utils/sq_dist.m` in the reference), with mean-centering for
    numerical stability.
    """
    mu = 0.5 * (jnp.mean(a, axis=0) + jnp.mean(b, axis=0))
    a = a - mu
    b = b - mu
    d2 = (jnp.sum(a * a, axis=1)[:, None] + jnp.sum(b * b, axis=1)[None, :]
          - 2.0 * a @ b.T)
    return jnp.maximum(d2, 0.0)


def logsumexp(x, axis=None, b=None, keepdims=False):
    return jax.scipy.special.logsumexp(x, axis=axis, b=b, keepdims=keepdims)


def mvn_kl(mu1, sigma1, mu2, sigma2):
    """KL(N1 || N2) and KL(N2 || N1) between two full-covariance Gaussians
    (cf. `shared/mvnkl.m`)."""
    mu1 = jnp.ravel(mu1)
    mu2 = jnp.ravel(mu2)
    D = mu1.shape[0]
    dmu = (mu2 - mu1)[:, None]

    def _kl(m_from_cov, to_cov, dmu):
        L = jnp.linalg.cholesky(to_cov)
        sol = jax.scipy.linalg.cho_solve((L, True), m_from_cov)
        quad = jax.scipy.linalg.cho_solve((L, True), dmu)
        logdet_to = 2.0 * jnp.sum(jnp.log(jnp.diag(L)))
        sign, logdet_from = jnp.linalg.slogdet(m_from_cov)
        return 0.5 * (jnp.trace(sol) + (dmu.T @ quad)[0, 0] - D
                      + logdet_to - logdet_from)

    kl1 = _kl(sigma1, sigma2, dmu)
    kl2 = _kl(sigma2, sigma1, -dmu)
    return jnp.maximum(kl1, 0.0), jnp.maximum(kl2, 0.0)


def quantile(x, q):
    return jnp.quantile(x, q)


def weighted_mean_cov(X, w):
    """Weighted mean and covariance of rows of X with weights w (sum to 1)."""
    w = w / jnp.sum(w)
    mu = jnp.sum(w[:, None] * X, axis=0)
    Xc = X - mu
    cov = (w[:, None] * Xc).T @ Xc
    return mu, cov


def next_bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (static, host-side shape planning)."""
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


# Shape-bucket ladders. Every jitted kernel is keyed by the padded shapes,
# so each rung of a ladder is a separate XLA compile. Two profiles:
#
# - "fine": tight padding, minimal wasted FLOPs. Right for CPU, where the
#   padded compute is the cost and local compiles are cheap.
# - "coarse": few, wide rungs: fewer compiles at the price of padded
#   compute (N=257 pads to 512). Whether that trade pays on a GPU is not
#   measured yet.
#
# Default: coarse on accelerators, fine on CPU; override with
# VBMC_BUCKETS=fine|coarse or set_bucket_mode().
_FINE_N = (32, 64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 1024)
_FINE_K = (4, 8, 12, 16, 24, 32, 40, 52, 64)
_FINE_NS = (1, 2, 4, 8, 16, 32, 48, 64, 80)
# Coarse rungs are chosen so a default run (N <= ~150 evals, K <= ~28,
# ns <= 16) NEVER crosses a bucket boundary after the first iterations:
# each crossing recompiles every kernel at the new shape.
_COARSE_N = (128, 256, 512, 1024)
_COARSE_K = (32, 64)
_COARSE_NS = (16, 80)

N_BUCKETS = _FINE_N     # full ladder (top rung shared by both profiles)
K_BUCKETS = _FINE_K
NS_BUCKETS = _FINE_NS

_bucket_mode = None


def bucket_mode() -> str:
    """Resolve the active bucket profile ("fine" | "coarse"), lazily."""
    global _bucket_mode
    if _bucket_mode is None:
        import os
        v = os.environ.get("VBMC_BUCKETS", "auto")
        if v in ("fine", "coarse"):
            _bucket_mode = v
        else:
            _bucket_mode = ("fine" if jax.default_backend() == "cpu"
                            else "coarse")
    return _bucket_mode


def set_bucket_mode(mode: str):
    """Force the bucket profile (tests / benchmarking)."""
    global _bucket_mode
    if mode not in ("fine", "coarse", None):
        raise ValueError("mode must be 'fine', 'coarse', or None (auto)")
    _bucket_mode = mode


def bucket_n(n: int) -> int:
    return next_bucket(n, _COARSE_N if bucket_mode() == "coarse"
                       else _FINE_N)


def bucket_k(k: int) -> int:
    return next_bucket(k, _COARSE_K if bucket_mode() == "coarse"
                       else _FINE_K)


def bucket_ns(ns: int) -> int:
    return next_bucket(max(ns, 1), _COARSE_NS if bucket_mode() == "coarse"
                       else _FINE_NS)


def bucket_pow2(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    p = lo
    while p < n:
        p *= 2
    return p


def pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0.0) -> np.ndarray:
    """Pad a host array along ``axis`` to length ``n`` with ``fill``."""
    x = np.asarray(x)
    pad = n - x.shape[axis]
    if pad < 0:
        raise ValueError(f"cannot pad axis {axis} of length {x.shape[axis]} to {n}")
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)
