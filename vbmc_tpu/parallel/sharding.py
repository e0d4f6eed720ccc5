"""Device-mesh sharding for the embarrassingly parallel axes of VBMC
(SURVEY §2.8): acquisition candidate grids, GP hyperparameter-sample
ensembles, and MCMC chains.

Design: a 1-D mesh over all devices; batch axes are sharded with
`NamedSharding` and the computation is expressed as ordinary jitted code —
XLA inserts the all-gather/reduce collectives (argmin of acquisition values,
moment averaging over hyperparameter samples). No hand-written
collectives are needed at these sizes; `shard_map` entry points are provided
where explicit control is wanted.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vbmc_tpu.gp.config import GPConfig


def make_mesh(devices=None, axis_name: str = "dev") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(mesh: Mesh, x: jnp.ndarray, axis_name: str = "dev"):
    """Place ``x`` sharded along axis 0 over the mesh (padding to a multiple
    of the device count is the caller's responsibility)."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


@partial(jax.jit, static_argnames=("cfg", "name", "n"))
def _sweep_kernel(cfg: GPConfig, name: str, n: int, Xs, vp, gp, state):
    from vbmc_tpu.acquisitions import evaluate_acquisition
    acq = evaluate_acquisition(cfg, name, Xs, vp, gp, state)
    acq = jnp.where(jnp.arange(acq.shape[0]) < n, acq, jnp.inf)
    best = jnp.argmin(acq)
    return Xs[best], acq[best], acq


def sharded_acquisition_sweep(mesh: Mesh, cfg: GPConfig, name: str,
                              Xs, vp, gp, state, axis_name: str = "dev"):
    """Acquisition sweep with the candidate axis sharded across the mesh.

    Returns (best_x, best_acq, acq_values). The argmin reduction crosses
    shards; XLA lowers it to an all-reduce. The kernel is a
    module-level jit — repeated calls hit the compile cache.
    """
    n = Xs.shape[0]
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    if pad:
        Xs = jnp.concatenate([Xs, jnp.tile(Xs[-1:], (pad, 1))], axis=0)
    Xs = shard_batch(mesh, Xs, axis_name)
    vp, gp, state = replicate(mesh, (vp, gp, state))
    return _sweep_kernel(cfg, name, n, Xs, vp, gp, state)


@partial(jax.jit, static_argnames=("cfg", "flags"))
def _elbo_step_kernel(cfg: GPConfig, flags, theta, gp, mu0, sigma0, lam0,
                      w0, kmask):
    from vbmc_tpu import elbo as eb

    def f(th):
        F, _ = eb.negelcbo(cfg, th, gp, mu0, sigma0, lam0, w0, kmask,
                           flags, 0.0, 0, 0, jax.random.PRNGKey(0))
        return F
    return jax.value_and_grad(f)(theta)


def sharded_hyp_ensemble_step(mesh: Mesh, cfg: GPConfig, theta, gp,
                              mu0, sigma0, lam0, w0, kmask, flags,
                              axis_name: str = "dev"):
    """One ELBO value+gradient step with the GP hyperparameter-sample axis
    sharded across the mesh: each device holds a slice of the posterior
    factorizations (alpha, L) and computes its partial quadrature; the
    sample average is a cross-device mean (psum)."""
    sharded_gp = gp._replace(
        hyp=shard_batch(mesh, gp.hyp, axis_name),
        hyp_mask=shard_batch(mesh, gp.hyp_mask, axis_name),
        alpha=shard_batch(mesh, gp.alpha, axis_name),
        L=shard_batch(mesh, gp.L, axis_name),
        Binv=shard_batch(mesh, gp.Binv, axis_name),
        sn2=shard_batch(mesh, gp.sn2, axis_name),
    )
    rest = replicate(mesh, (theta, mu0, sigma0, lam0, w0, kmask))
    theta, mu0, sigma0, lam0, w0, kmask = rest
    return _elbo_step_kernel(cfg, flags, theta, sharded_gp, mu0, sigma0,
                             lam0, w0, kmask)


def sharded_slice_chains(mesh: Mesh, logpdf_args_fn, x0s, widths, lb, ub,
                         n_keep, burn, thin, n_keep_max: int,
                         key, axis_name: str = "dev"):
    """Slice-sampling chains sharded across devices (chains = data axis).
    ``logpdf_args_fn`` is a closure, so this entry point retraces per
    target; the in-loop path shards chains through `gp/fit.py` instead."""
    from vbmc_tpu.samplers.slice import slice_sample_chain

    C = x0s.shape[0]
    keys = jax.random.split(key, C)
    x0s = shard_batch(mesh, x0s, axis_name)
    keys = shard_batch(mesh, keys, axis_name)

    def one(k, x0):
        return slice_sample_chain(k, logpdf_args_fn, x0, widths, lb, ub,
                                  n_keep, burn, thin, n_keep_max)
    return jax.jit(jax.vmap(one))(keys, x0s)
