"""GP output warping ("fitness shaping").

Monotone warps of the observed log-density that compress the deep tail
below a learned threshold ``y0``, so the GP does not waste capacity (and
length-scale) fitting the very low-density region. Reference behavior:
`gplite/outwarp_negpow.m`, `outwarp_negpowc1.m`, `outwarp_negscaledpow.m`.

Design notes: every warp is a branchless elementwise transform (select
on ``y < y0``) differentiable by autodiff — the reference's hand-coded
hyperparameter gradients (`outwarp_negpowc1.m:104-125`) are not needed and
serve only as a test oracle. The warp identifier is part of the static
`GPConfig`, so each variant compiles its own fused kernel.

Conventions (matching the reference):
- ``direct``: observation space -> warped (GP) space, identity above y0.
- ``inverse``: warped space -> observation space.
- ``deriv``: d(warped)/d(y), used for the nlZ Jacobian correction
  (`gplite_core.m:196-198`), warped user noise s2 * g'(y)^2
  (`gplite_core.m:22-26`) and the delta-method prediction variance
  (`gplite_pred.m:130-149`).

Hyperparameter layout per variant:
- NEGPOW (1):        [y0, log k]
- NEGPOWC1 (2):      [y0, log k]   (C1-continuous at the threshold)
- NEGSCALEDPOW (3):  [y0, log a, log k]
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

OUTWARP_NONE = 0
OUTWARP_NEGPOW = 1
OUTWARP_NEGPOWC1 = 2
OUTWARP_NEGSCALEDPOW = 3

N_OUTWARP_HYP = {OUTWARP_NONE: 0, OUTWARP_NEGPOW: 2, OUTWARP_NEGPOWC1: 2,
                 OUTWARP_NEGSCALEDPOW: 3}


def _split(outwarp_id: int, hyp_ow):
    y0 = hyp_ow[0]
    if outwarp_id == OUTWARP_NEGSCALEDPOW:
        return y0, jnp.exp(hyp_ow[1]), jnp.exp(hyp_ow[2])
    return y0, jnp.asarray(1.0, dtype=hyp_ow.dtype), jnp.exp(hyp_ow[1])


def outwarp_direct(outwarp_id: int, hyp_ow, y):
    """Warp observations y -> t (identity above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return y
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = y < y0
    if outwarp_id == OUTWARP_NEGPOW:
        d = jnp.where(below, y0 - y, 1.0)
        t = y0 - d ** k
    elif outwarp_id == OUTWARP_NEGPOWC1:
        d = jnp.where(below, 1.0 + y0 - y, 1.0)
        t = y0 - (d ** k) / k + 1.0 / k
    elif outwarp_id == OUTWARP_NEGSCALEDPOW:
        d = jnp.where(below, a * (y0 - y), 1.0)
        t = y0 - d ** k
    else:
        raise ValueError(f"unknown outwarp id {outwarp_id}")
    return jnp.where(below, t, y)


def outwarp_inverse(outwarp_id: int, hyp_ow, t):
    """Inverse warp t -> y (identity above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return t
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = t < y0
    if outwarp_id == OUTWARP_NEGPOW:
        d = jnp.where(below, y0 - t, 1.0)
        y = y0 - d ** (1.0 / k)
    elif outwarp_id == OUTWARP_NEGPOWC1:
        d = jnp.where(below, 1.0 + k * (y0 - t), 1.0)
        y = y0 + 1.0 - d ** (1.0 / k)
    elif outwarp_id == OUTWARP_NEGSCALEDPOW:
        d = jnp.where(below, y0 - t, 1.0)
        y = y0 - (d ** (1.0 / k)) / a
    else:
        raise ValueError(f"unknown outwarp id {outwarp_id}")
    return jnp.where(below, y, t)


def outwarp_deriv(outwarp_id: int, hyp_ow, y):
    """dt/dy at observation-space points y (1 above the threshold)."""
    if outwarp_id == OUTWARP_NONE:
        return jnp.ones_like(y)
    y0, a, k = _split(outwarp_id, hyp_ow)
    below = y < y0
    if outwarp_id == OUTWARP_NEGPOW:
        d = jnp.where(below, y0 - y, 1.0)
        g = k * d ** (k - 1.0)
    elif outwarp_id == OUTWARP_NEGPOWC1:
        d = jnp.where(below, 1.0 + y0 - y, 1.0)
        g = d ** (k - 1.0)
    elif outwarp_id == OUTWARP_NEGSCALEDPOW:
        d = jnp.where(below, a * (y0 - y), 1.0)
        g = a * k * d ** (k - 1.0)
    else:
        raise ValueError(f"unknown outwarp id {outwarp_id}")
    return jnp.where(below, g, jnp.ones_like(y))


def outwarp_info(outwarp_id: int, y: np.ndarray):
    """Bounds / plausible box / x0 for the warp hyperparameters (host-side;
    cf. the `'info'` branches of the three reference files)."""
    now = N_OUTWARP_HYP[outwarp_id]
    lb = np.full(now, -np.inf)
    ub = np.full(now, np.inf)
    plb = np.full(now, -np.inf)
    pub = np.full(now, np.inf)
    x0 = np.full(now, np.nan)
    if now == 0:
        return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
    if y.size <= 1:
        y = np.array([0.0, 1.0])
    # Threshold y0.
    lb[0] = plb[0] = y.min()
    ub[0] = pub[0] = y.max()
    if outwarp_id == OUTWARP_NEGSCALEDPOW:
        plb[1], pub[1], x0[1] = -2.0, 2.0, 0.0     # log a
        plb[2], pub[2], x0[2] = -3.0, 3.0, 0.0     # log k
    else:
        plb[1], pub[1], x0[1] = -3.0, 3.0, 0.0     # log k
    nan = np.isnan(x0)
    x0[nan] = 0.5 * (plb[nan] + pub[nan])
    return dict(lb=lb, ub=ub, plb=plb, pub=pub, x0=x0)
