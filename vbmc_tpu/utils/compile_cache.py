"""Where the persistent XLA compilation cache lives.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set in
  code.
- Unset, on a GPU: a fixed directory inside the checkout
  (``<checkout>/.jax_cache``, listed in ``.gitignore``). The path is part of
  the cache key, so it never depends on the working directory, a process id
  or the time. Every program is kept, however short its compile: a
  `vbmc()` run compiles hundreds of small programs, and JAX's default
  keeps only those that take over a second.
- Unset, on the CPU: no cache (the CPU AOT cache is brittle across CPU
  feature sets).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir(platform: str,
                      environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The cache directory for a backend ``platform`` ("gpu", "cpu", ...),
    or None when no persistent cache is used."""
    if environ.get(ENV):
        return environ[ENV]
    if platform == "gpu":
        return CHECKOUT_CACHE
    return None


def configure_compile_cache() -> Optional[str]:
    """Apply `compile_cache_dir` for the default backend; returns the
    directory in use (None: no persistent cache)."""
    cache_dir = compile_cache_dir(jax.default_backend())
    if cache_dir is not None and not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir
