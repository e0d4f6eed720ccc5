"""A JAX framework for sample-efficient Bayesian inference (VBMC).

Re-implements the capabilities of VBMC (Variational Bayesian Monte Carlo,
reference: acerbilab/vbmc) as an idiomatic JAX/XLA design: Gaussian-process
surrogate math batched over hyperparameter samples, Bayesian-quadrature ELBO
vectorized over mixture components, acquisition sweeps and MCMC chains as
data-parallel batches shardable over a device mesh.
"""

__version__ = "0.1.0"

_LAZY = {
    "Trinfo": "vbmc_tpu.transforms",
    "create_trinfo": "vbmc_tpu.transforms",
    "VBMCOptions": "vbmc_tpu.options",
    "VariationalPosterior": "vbmc_tpu.vp",
    "vp_rnd": "vbmc_tpu.vp",
    "vp_pdf": "vbmc_tpu.vp",
    "vp_moments": "vbmc_tpu.vp",
    "vp_mode": "vbmc_tpu.vp",
    "vp_kldiv": "vbmc_tpu.vp",
    "vp_mtv": "vbmc_tpu.vp",
    "vp_power": "vbmc_tpu.vp",
    "is_valid_vp": "vbmc_tpu.vp",
    "vbmc": "vbmc_tpu.main",
    "VBMCResult": "vbmc_tpu.main",
    "vbmc_diagnostics": "vbmc_tpu.diagnostics",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'vbmc_tpu' has no attribute {name!r}")
