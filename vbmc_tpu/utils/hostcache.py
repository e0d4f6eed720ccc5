"""Host mirrors of device arrays — kills redundant device→host pulls.

The orchestration layer re-reads arrays it *just uploaded* (GP training
data, VP parameters, hyperparameter samples): ~170 blocking pulls per VBMC
iteration otherwise. The fix is a side table keyed on the device array's
identity: wherever host code builds a device array from a numpy value (or
has just paid for a pull), it registers the host value; `to_np` then serves
later reads from the mirror for free.

Correctness contract: `register(dev, host)` may only be called when ``host``
is *the* value of ``dev`` (same content after dtype cast). Device arrays are
immutable, so a mirror can never go stale; entries are evicted when the
device array is garbage collected (weakref finalizer). Mirrors are stored
cast to the device dtype so cached reads are bit-identical to a real pull.
"""

from __future__ import annotations

import weakref

import numpy as np
import jax

_mirror: dict = {}   # id(device_array) -> np.ndarray


def _evict(key: int) -> None:
    _mirror.pop(key, None)


def register(dev, host: np.ndarray):
    """Record that device array ``dev`` holds the value ``host``.

    Returns ``dev`` for chaining. No-op for non-jax values or tracers."""
    if not isinstance(dev, jax.Array):
        return dev
    try:
        host = np.asarray(host)
        if host.dtype != dev.dtype:
            host = host.astype(dev.dtype)
        if host.shape != dev.shape:
            return dev
        key = id(dev)
        _mirror[key] = host
        weakref.finalize(dev, _evict, key)
    except Exception:
        pass
    return dev


def device_put_cached(host: np.ndarray, dtype=None):
    """jnp.asarray + register, in one call."""
    import jax.numpy as jnp
    host = np.asarray(host)
    dev = jnp.asarray(host, dtype=dtype)
    register(dev, host)
    return dev


def to_np(x) -> np.ndarray:
    """np.asarray(x) served from the host mirror when available.

    On a miss the pulled value is registered, so repeated reads of the same
    device array pay the transfer once."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, jax.Array):
        v = _mirror.get(id(x))
        if v is not None:
            return v
        v = np.asarray(x)
        register(x, v)
        return v
    return np.asarray(x)


def reregister(new, old):
    """Propagate ``old``'s mirror (if any) to ``new`` (e.g. after a
    device_put resharding, which preserves the value). Returns ``new``."""
    if isinstance(old, jax.Array) and isinstance(new, jax.Array):
        v = _mirror.get(id(old))
        if v is not None:
            register(new, v)
    return new


def cache_size() -> int:
    return len(_mirror)
