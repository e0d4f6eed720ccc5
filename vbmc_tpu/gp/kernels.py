"""Covariance functions (cf. `gplite/gplite_covfun.m`).

Gram matrices are computed as one large matmul plus elementwise transform —
a shape XLA fuses well (a GEMM for the distances, one fused elementwise
kernel for the exp). All functions are dense over padded shapes; masking happens in
`core.py`.

Families follow the reference ids (`gplite_covfun.m:77-91`): 0 'seiso'
(single length scale, 2 hyps), 1 'se' ard (D+1 hyps, the VBMC default),
3 'matern' ard with degree nu in {1,3,5} (`GPConfig.cov_nu`, D+1 hyps).
"""

from __future__ import annotations

import jax.numpy as jnp

from vbmc_tpu.gp.config import GPConfig, COV_SEISO, COV_SEARD, COV_MATERN
from vbmc_tpu.utils.math import sq_dist


def kernel_cross(cfg: GPConfig, hyp: jnp.ndarray, Xa: jnp.ndarray,
                 Xb: jnp.ndarray) -> jnp.ndarray:
    """k(Xa, Xb) for a single hyperparameter vector. (n,m) output."""
    ell = jnp.exp(hyp[cfg.sl_log_ell])   # (1,) for iso broadcasts over D
    sf2 = jnp.exp(2.0 * hyp[cfg.idx_log_sf])
    A = Xa / ell
    B = Xb / ell
    d2 = sq_dist(A, B)
    if cfg.covfun in (COV_SEARD, COV_SEISO):
        return sf2 * jnp.exp(-0.5 * d2)
    elif cfg.covfun == COV_MATERN:
        # Matérn nu in {1,3,5}: K = sf2 * f(t) * exp(-t), t = sqrt(nu)*r
        # (`gplite_covfun.m:195-214`). sqrt is guarded with the double-where
        # pattern: the Gram diagonal (and identical padded rows) has d2 = 0,
        # where d sqrt/d d2 = inf and autodiff would propagate NaN into the
        # length-scale gradients; the true dK/dell there is 0.
        d2c = jnp.maximum(cfg.cov_nu * d2, 0.0)
        pos = d2c > 0
        t = jnp.where(pos, jnp.sqrt(jnp.where(pos, d2c, 1.0)), 0.0)
        if cfg.cov_nu == 1:
            f = 1.0
        elif cfg.cov_nu == 3:
            f = 1.0 + t
        elif cfg.cov_nu == 5:
            f = 1.0 + t * (1.0 + t / 3.0)
        else:
            raise ValueError(
                f"Matérn degree nu must be 1, 3 or 5 (got {cfg.cov_nu})")
        return sf2 * f * jnp.exp(-t)
    raise ValueError(f"unsupported covfun {cfg.covfun}")


def kernel_diag(cfg: GPConfig, hyp: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """k(x,x) for each row of X: constant sf^2 for stationary kernels."""
    sf2 = jnp.exp(2.0 * hyp[cfg.idx_log_sf])
    return jnp.full(X.shape[0], sf2, dtype=X.dtype)
