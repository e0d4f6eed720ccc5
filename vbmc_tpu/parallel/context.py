"""Process-wide device-mesh context for in-loop sharding.

When more than one device is visible, `vbmc()` runs its embarrassingly
parallel batch axes sharded over a 1-D mesh (SURVEY §2.8):

- GP hyperparameter-sample ensembles (the S axis of every posterior array:
  alpha, L, Binv, sn2) — the reduction over samples in prediction,
  quadrature and the BQ-ELBO (`gplogjoint.m:398-413`) becomes a
  cross-device psum;
- sieve candidate batches (`vpsieve_vbmc.m:74-78`) and the GP-hyperparameter
  design evaluations (`fminfill`) — pure data parallelism;
- acquisition candidate grids, through the fused proposal programs (the
  sharded S axis rides into them).

The integration style is the canonical JAX recipe: place the inputs with a
`NamedSharding`, call the SAME module-level jitted kernels, and let GSPMD
propagate shardings and insert the collectives. Numerics are unchanged
(verified by `tests/test_sharding.py` parity checks); only the layout is.

Enable/disable with VBMC_SHARD=1/0 (default: auto — on when
`len(jax.devices()) > 1`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "dev"

_mesh: Optional[Mesh] = None
_resolved = False


def get_mesh() -> Optional[Mesh]:
    """The process mesh, or None when sharding is off (single device)."""
    global _mesh, _resolved
    if not _resolved:
        _resolved = True
        flag = os.environ.get("VBMC_SHARD", "auto")
        if flag == "0":
            _mesh = None
        else:
            devs = jax.devices()
            if len(devs) > 1 or (flag == "1" and len(devs) >= 1):
                _mesh = Mesh(np.asarray(devs), (AXIS,))
            else:
                _mesh = None
    return _mesh


def reset_mesh():
    """Re-resolve on next use (tests)."""
    global _resolved, _mesh
    _resolved = False
    _mesh = None


def shard_rows(x, mesh: Optional[Mesh] = None):
    """Shard axis 0 of ``x`` over the mesh when its length divides evenly;
    otherwise return ``x`` unchanged (the kernel still runs, replicated)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return x
    n_dev = mesh.devices.size
    if x.shape[0] % n_dev != 0:
        return x
    return jax.device_put(x, NamedSharding(mesh, P(AXIS)))


def shard_gp(gp, mesh: Optional[Mesh] = None):
    """Shard the hyperparameter-sample (S) axis of a GP's posterior arrays.

    Every downstream consumer vmaps over S and mean-reduces at the end, so
    GSPMD turns the reduction into a cross-device psum. No-op when the mesh
    is off or S does not divide the device count.
    """
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return gp
    n_dev = mesh.devices.size
    if gp.hyp.shape[0] % n_dev != 0:
        return gp
    from vbmc_tpu.utils.hostcache import reregister
    row = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    return gp._replace(
        hyp=reregister(jax.device_put(gp.hyp, row), gp.hyp),
        hyp_mask=reregister(jax.device_put(gp.hyp_mask, row), gp.hyp_mask),
        alpha=jax.device_put(gp.alpha, row),
        L=jax.device_put(gp.L, row),
        Binv=jax.device_put(gp.Binv, row),
        sn2=jax.device_put(gp.sn2, row),
        X=reregister(jax.device_put(gp.X, rep), gp.X),
        y=reregister(jax.device_put(gp.y, rep), gp.y),
        mask=reregister(jax.device_put(gp.mask, rep), gp.mask),
    )


def replicate(tree, mesh: Optional[Mesh] = None):
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return tree
    return jax.device_put(tree, NamedSharding(mesh, P()))
