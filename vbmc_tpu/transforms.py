"""Parameter-space transforms (constrained <-> unconstrained) for VBMC.

A re-design of the reference transform layer
(``shared/warpvars_vbmc.m``): instead of a per-dimension switch statement
dispatching on the transform type, every transform family is evaluated
branchlessly on safe inputs and the result is selected with ``jnp.where`` on
a per-dimension type code.  This keeps the whole map jit/vmap-compatible with
static shapes, so it can be fused into acquisition sweeps and density
evaluations on-device.

Transform types (per dimension), matching the reference semantics
(`warpvars_vbmc.m:77-110, 463-503, 856-920`):

  0  unbounded:            y = (x - mu) / delta              (affine recenter)
  1  lower-bounded:        y = log(x - a)
  2  upper-bounded:        y = log(b - x)
  3  bounded (logit):      y = (logit((x-a)/(b-a)) - mu) / delta
  12 bounded (probit):     y = (norminv((x-a)/(b-a)) - mu) / delta
  13 bounded (student-t4): y = (t4inv((x-a)/(b-a)) - mu) / delta

After the per-dimension scalar maps, an optional affine "rotoscale" stage is
applied (`warpvars_vbmc.m:274,288,469`): y' = (y @ R) / scale, used by the
input-warping subsystem.

The log-Jacobian convention follows the reference 'logprob' action: for a
density p_orig on X, the transformed log density is
``log p_orig(x(y)) + log_abs_det_jacobian(trinfo, y)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri, ndtr


class Trinfo(NamedTuple):
    """Transform description; a pytree of per-dimension arrays.

    ``R_mat``/``scale`` are ``None`` until an input warp installs them.
    """

    type: jnp.ndarray          # (D,) int32 type codes
    lb_orig: jnp.ndarray       # (D,) original-space lower bounds
    ub_orig: jnp.ndarray       # (D,) original-space upper bounds
    mu: jnp.ndarray            # (D,) affine center (types 0, 3, 12, 13)
    delta: jnp.ndarray         # (D,) affine scale  (types 0, 3, 12, 13)
    R_mat: Optional[jnp.ndarray] = None   # (D,D) rotation (orthogonal)
    scale: Optional[jnp.ndarray] = None   # (D,) post-rotation scaling

    @property
    def ndim(self) -> int:
        return self.type.shape[0]


LOGIT, PROBIT, STUDENT4 = 3, 12, 13

_TINY = 1e-300


def _t4_cdf(u):
    """CDF of Student's t with nu=4: F(u) = 1/2 + s(3 - s^2)/4, s=u/sqrt(u^2+4)."""
    s = u / jnp.sqrt(u * u + 4.0)
    return 0.5 + 0.25 * s * (3.0 - s * s)


def _t4_icdf(p):
    """Inverse CDF of Student's t with nu=4 (closed form, Shaw 2006)."""
    # alpha = 4 p (1 - p); q = cos(arccos(sqrt(alpha))/3)/sqrt(alpha)
    p = jnp.clip(p, _TINY, 1.0 - 1e-16)
    alpha = 4.0 * p * (1.0 - p)
    sqrt_alpha = jnp.sqrt(alpha)
    q = jnp.cos(jnp.arccos(sqrt_alpha) / 3.0) / sqrt_alpha
    return jnp.sign(p - 0.5) * 2.0 * jnp.sqrt(q - 1.0)


def create_trinfo(lb, ub, plb=None, pub=None, bounded_type: int = LOGIT,
                  dtype=None) -> Trinfo:
    """Build a :class:`Trinfo` from bounds (host-side setup code).

    Mirrors the constructor logic of `warpvars_vbmc.m:856-920`: the type per
    dimension is inferred from bound finiteness, and the affine recentering
    (mu, delta) is set from the *transformed* plausible box.
    """
    lb = np.asarray(lb, dtype=np.float64).ravel()
    ub = np.asarray(ub, dtype=np.float64).ravel()
    D = lb.shape[0]
    if plb is None:
        plb = lb.copy()
    if pub is None:
        pub = ub.copy()
    plb = np.asarray(plb, dtype=np.float64).ravel()
    pub = np.asarray(pub, dtype=np.float64).ravel()

    if not np.all((lb <= plb) & (plb < pub) & (pub <= ub)):
        raise ValueError("Bounds must satisfy LB <= PLB < PUB <= UB.")

    types = np.zeros(D, dtype=np.int32)
    types[np.isfinite(lb) & ~np.isfinite(ub)] = 1
    types[~np.isfinite(lb) & np.isfinite(ub)] = 2
    types[np.isfinite(lb) & np.isfinite(ub)] = bounded_type

    if dtype is None:
        dtype = jnp.zeros(0).dtype  # respects jax_enable_x64

    from vbmc_tpu.utils.hostcache import device_put_cached as _dpc
    # R_mat/scale are ALWAYS present (identity until an input warp installs
    # a real rotoscale): a None -> array flip would change the pytree
    # STRUCTURE of every vp/trinfo argument, recompiling the entire jitted
    # kernel universe at the first warp. The identity matmul is negligible
    # at D <= 20.
    base = Trinfo(
        type=_dpc(types),
        lb_orig=_dpc(lb, dtype=dtype),
        ub_orig=_dpc(ub, dtype=dtype),
        mu=_dpc(np.zeros(D), dtype=dtype),
        delta=_dpc(np.ones(D), dtype=dtype),
        R_mat=_dpc(np.eye(D), dtype=dtype),
        scale=_dpc(np.ones(D), dtype=dtype),
    )

    # Center in transformed space using the plausible box (host math: the
    # trinfo is consumed by the host-side function logger every evaluation).
    t_plb = direct_np(base, plb[None, :])[0]
    t_pub = direct_np(base, pub[None, :])[0]
    mu = np.zeros(D)
    delta = np.ones(D)
    ok = np.isfinite(t_plb) & np.isfinite(t_pub)
    mu[ok] = 0.5 * (t_plb[ok] + t_pub[ok])
    delta[ok] = t_pub[ok] - t_plb[ok]

    return base._replace(mu=_dpc(mu, dtype=dtype),
                         delta=_dpc(delta, dtype=dtype))


def _safe_bounds(trinfo: Trinfo):
    t = trinfo.type
    a = jnp.where(jnp.isfinite(trinfo.lb_orig), trinfo.lb_orig, 0.0)
    b = jnp.where(jnp.isfinite(trinfo.ub_orig), trinfo.ub_orig, 1.0)
    b = jnp.where(b > a, b, a + 1.0)
    return t, a, b


def direct(trinfo: Trinfo, x: jnp.ndarray) -> jnp.ndarray:
    """Map original-space points ``x`` (..., D) to unconstrained space."""
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta

    y0 = (x - mu) / delta
    # Guard logs with clipping; exact-boundary inputs map to -/+inf naturally.
    y1 = jnp.log(jnp.maximum(x - a, _TINY))
    y2 = jnp.log(jnp.maximum(b - x, _TINY))

    z = jnp.clip((x - a) / (b - a), _TINY, 1.0 - 1e-16)
    u_logit = jnp.log(z) - jnp.log1p(-z)
    u_probit = ndtri(z)
    u_t4 = _t4_icdf(z)
    u = jnp.where(t == LOGIT, u_logit,
                  jnp.where(t == PROBIT, u_probit, u_t4))
    y3 = (u - mu) / delta

    y = jnp.where(t == 0, y0, jnp.where(t == 1, y1,
                                        jnp.where(t == 2, y2, y3)))

    if trinfo.R_mat is not None:
        # Rows with non-finite entries bypass the rotation: inf * 0 in the
        # matmul would turn them into NaN (R_mat is always present, identity
        # until a warp; +-inf coordinates must survive as +-inf, exactly as
        # in the unrotated map).
        finite = jnp.all(jnp.isfinite(y), axis=-1, keepdims=True)
        y = jnp.where(finite, jnp.where(finite, y, 0.0) @ trinfo.R_mat, y)
    if trinfo.scale is not None:
        y = y / trinfo.scale
    return y


def _unrotate(trinfo: Trinfo, y: jnp.ndarray) -> jnp.ndarray:
    """Undo the rotoscale stage, returning per-dimension scalar coords."""
    if trinfo.scale is not None:
        y = y * trinfo.scale
    if trinfo.R_mat is not None:
        finite = jnp.all(jnp.isfinite(y), axis=-1, keepdims=True)
        y = jnp.where(finite, jnp.where(finite, y, 0.0) @ trinfo.R_mat.T, y)
    return y


def inverse(trinfo: Trinfo, y: jnp.ndarray) -> jnp.ndarray:
    """Map unconstrained points ``y`` (..., D) back to original space."""
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta
    y = _unrotate(trinfo, y)

    x0 = mu + delta * y
    x1 = a + jnp.exp(y)
    x2 = b - jnp.exp(y)

    u = y * delta + mu
    z_logit = jax.nn.sigmoid(u)
    z_probit = ndtr(u)
    z_t4 = _t4_cdf(u)
    z = jnp.where(t == LOGIT, z_logit,
                  jnp.where(t == PROBIT, z_probit, z_t4))
    x3 = a + (b - a) * z

    x = jnp.where(t == 0, x0, jnp.where(t == 1, x1,
                                        jnp.where(t == 2, x2, x3)))
    # Clamp bounded dims inside their hard bounds (numerical safety).
    bounded = (t == LOGIT) | (t == PROBIT) | (t == STUDENT4)
    x = jnp.where(bounded, jnp.clip(x, a, b), x)
    return x


def log_abs_det_jacobian(trinfo: Trinfo, y: jnp.ndarray) -> jnp.ndarray:
    """log |dx/dy| summed over dimensions, evaluated at unconstrained ``y``.

    This is the reference 'logprob' correction (`warpvars_vbmc.m:463-503`):
    the transformed-space log density is the original log density plus this.
    """
    t, a, b = _safe_bounds(trinfo)
    mu, delta = trinfo.mu, trinfo.delta
    y_s = _unrotate(trinfo, y)

    p0 = jnp.log(delta) * jnp.ones_like(y_s)
    p12 = y_s  # types 1 and 2: log|dx/dy| = y

    u = y_s * delta + mu
    lab = jnp.log(b - a)
    p_logit = lab - jax.nn.softplus(u) - jax.nn.softplus(-u) + jnp.log(delta)
    p_probit = lab - 0.5 * jnp.log(2 * jnp.pi) - 0.5 * u * u + jnp.log(delta)
    p_t4 = (lab + jnp.log(3.0 / 8.0) - 2.5 * jnp.log1p(u * u / 4.0)
            + jnp.log(delta))
    p3 = jnp.where(t == LOGIT, p_logit,
                   jnp.where(t == PROBIT, p_probit, p_t4))

    p = jnp.where(t == 0, p0, jnp.where((t == 1) | (t == 2), p12, p3))
    if trinfo.scale is not None:
        p = p + jnp.log(trinfo.scale)
    return jnp.sum(p, axis=-1)


def pdf_correction(trinfo: Trinfo, y: jnp.ndarray) -> jnp.ndarray:
    """|dx/dy| multiplier (the reference 'prob' action)."""
    return jnp.exp(log_abs_det_jacobian(trinfo, y))


# ----------------------------------------------------------------------
# Host (numpy) twins — same math on the CPU, for host-side consumers.
#
# The function logger runs one inverse + one log-Jacobian per target
# evaluation; each device call would add a dispatch and a blocking pull,
# so the per-evaluation bookkeeping stays on the host. The
# jax implementations above remain the jit/vmap path used inside kernels.
# ----------------------------------------------------------------------

def _host_fields(trinfo: Trinfo):
    from vbmc_tpu.utils.hostcache import to_np
    t = to_np(trinfo.type)
    lb = np.asarray(to_np(trinfo.lb_orig), float)
    ub = np.asarray(to_np(trinfo.ub_orig), float)
    a = np.where(np.isfinite(lb), lb, 0.0)
    b = np.where(np.isfinite(ub), ub, 1.0)
    b = np.where(b > a, b, a + 1.0)
    mu = np.asarray(to_np(trinfo.mu), float)
    delta = np.asarray(to_np(trinfo.delta), float)
    R = None if trinfo.R_mat is None else np.asarray(to_np(trinfo.R_mat), float)
    s = None if trinfo.scale is None else np.asarray(to_np(trinfo.scale), float)
    return t, a, b, mu, delta, R, s


def _t4_cdf_np(u):
    s = u / np.sqrt(u * u + 4.0)
    return 0.5 + 0.25 * s * (3.0 - s * s)


def _t4_icdf_np(p):
    p = np.clip(p, _TINY, 1.0 - 1e-16)
    alpha = 4.0 * p * (1.0 - p)
    sqrt_alpha = np.sqrt(alpha)
    q = np.cos(np.arccos(sqrt_alpha) / 3.0) / sqrt_alpha
    return np.sign(p - 0.5) * 2.0 * np.sqrt(q - 1.0)


def direct_np(trinfo: Trinfo, x: np.ndarray) -> np.ndarray:
    from scipy.special import ndtri as _ndtri
    t, a, b, mu, delta, R, s = _host_fields(trinfo)
    x = np.asarray(x, float)

    y0 = (x - mu) / delta
    with np.errstate(divide="ignore", invalid="ignore"):
        y1 = np.log(np.maximum(x - a, _TINY))
        y2 = np.log(np.maximum(b - x, _TINY))
        z = np.clip((x - a) / (b - a), _TINY, 1.0 - 1e-16)
        u = np.where(t == LOGIT, np.log(z) - np.log1p(-z),
                     np.where(t == PROBIT, _ndtri(z), _t4_icdf_np(z)))
    y3 = (u - mu) / delta
    y = np.where(t == 0, y0, np.where(t == 1, y1, np.where(t == 2, y2, y3)))
    if R is not None:
        finite = np.all(np.isfinite(y), axis=-1, keepdims=True)
        y = np.where(finite, np.where(finite, y, 0.0) @ R, y)
    if s is not None:
        y = y / s
    return y


def _unrotate_np(y, R, s):
    if s is not None:
        y = y * s
    if R is not None:
        finite = np.all(np.isfinite(y), axis=-1, keepdims=True)
        y = np.where(finite, np.where(finite, y, 0.0) @ R.T, y)
    return y


def inverse_np(trinfo: Trinfo, y: np.ndarray) -> np.ndarray:
    from scipy.special import ndtr as _ndtr
    t, a, b, mu, delta, R, s = _host_fields(trinfo)
    y = _unrotate_np(np.asarray(y, float), R, s)

    x0 = mu + delta * y
    with np.errstate(over="ignore"):
        x1 = a + np.exp(y)
        x2 = b - np.exp(y)
    u = y * delta + mu
    with np.errstate(over="ignore"):
        z = np.where(t == LOGIT, 1.0 / (1.0 + np.exp(-u)),
                     np.where(t == PROBIT, _ndtr(u), _t4_cdf_np(u)))
    x3 = a + (b - a) * z
    x = np.where(t == 0, x0, np.where(t == 1, x1, np.where(t == 2, x2, x3)))
    bounded = (t == LOGIT) | (t == PROBIT) | (t == STUDENT4)
    x = np.where(bounded, np.clip(x, a, b), x)
    return x


def log_abs_det_jacobian_np(trinfo: Trinfo, y: np.ndarray) -> np.ndarray:
    t, a, b, mu, delta, R, s = _host_fields(trinfo)
    y_s = _unrotate_np(np.asarray(y, float), R, s)

    # delta is negative for upper-bounded (type 2) dims; the NaN it produces
    # in the unselected lanes is discarded by the where-select, exactly as in
    # the jax path above.
    with np.errstate(invalid="ignore", divide="ignore"):
        p0 = np.log(delta) * np.ones_like(y_s)
        p12 = y_s
        u = y_s * delta + mu
        lab = np.log(b - a)

        def _softplus(v):
            return np.logaddexp(0.0, v)

        p_logit = lab - _softplus(u) - _softplus(-u) + np.log(delta)
        p_probit = lab - 0.5 * np.log(2 * np.pi) - 0.5 * u * u + np.log(delta)
        p_t4 = (lab + np.log(3.0 / 8.0) - 2.5 * np.log1p(u * u / 4.0)
                + np.log(delta))
        p3 = np.where(t == LOGIT, p_logit,
                      np.where(t == PROBIT, p_probit, p_t4))
    p = np.where(t == 0, p0, np.where((t == 1) | (t == 2), p12, p3))
    if s is not None:
        p = p + np.log(s)
    return np.sum(p, axis=-1)


def real_to_int(trinfo: Trinfo, y: jnp.ndarray,
                integer_mask: jnp.ndarray) -> jnp.ndarray:
    """Round integer dimensions through the transform
    (cf. `misc/real2int_vbmc.m`): map to original space, round the flagged
    dims, map back."""
    if integer_mask is None or not bool(np.any(np.asarray(integer_mask))):
        return y
    x = inverse(trinfo, y)
    x = jnp.where(jnp.asarray(integer_mask)[None, :], jnp.round(x), x)
    return direct(trinfo, x)
