"""Compile-surface audit: run a representative VBMC problem and report how
many distinct XLA executables (jit cache entries) each kernel accumulated.

The jit cache key is (static args, input shapes/dtypes); every entry is one
XLA compile, so the
bucket ladders in `utils/math.py` exist to keep these counts low. Run:

    python tools/compile_audit.py [--noisy] [--d D] [--evals N]
"""

import argparse
import gc
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def audit():
    fns = []
    for obj in gc.get_objects():
        try:
            name = type(obj).__name__
        except Exception:
            continue
        if name in ("PjitFunction", "JitWrapped") or (
                hasattr(obj, "_cache_size") and hasattr(obj, "__wrapped__")):
            try:
                n = obj._cache_size()
            except Exception:
                continue
            if n > 0:
                label = getattr(obj, "__name__", repr(obj))
                mod = getattr(getattr(obj, "__wrapped__", None),
                              "__module__", "?")
                fns.append((f"{mod}.{label}", n))
    return sorted(fns, key=lambda t: -t[1])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--noisy", action="store_true")
    p.add_argument("--d", type=int, default=2)
    p.add_argument("--evals", type=int, default=60)
    args = p.parse_args()

    from vbmc_tpu import vbmc, VBMCOptions

    D = args.d
    sd = np.linspace(0.6, 1.4, D)
    rng = np.random.default_rng(0)

    if args.noisy:
        def fun(x):
            y = float(-0.5 * np.sum((x / sd) ** 2)
                      - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)))
            return y + rng.standard_normal(), 1.0
    else:
        def fun(x):
            return float(-0.5 * np.sum((x / sd) ** 2)
                         - 0.5 * D * np.log(2 * np.pi) - np.sum(np.log(sd)))

    opts = VBMCOptions(display="off", max_fun_evals=args.evals, seed=1,
                       specify_target_noise=args.noisy,
                       min_final_components=20)
    vbmc(fun, x0=np.full(D, 0.3), plb=np.full(D, -3.0), pub=np.full(D, 3.0),
         options=opts)

    rows = audit()
    total = sum(n for _, n in rows)
    print(f"# compile-surface audit: D={D} evals={args.evals} "
          f"noisy={args.noisy}")
    for label, n in rows:
        print(f"{n:5d}  {label}")
    print(f"TOTAL jit cache entries: {total} across {len(rows)} kernels")


if __name__ == "__main__":
    main()
