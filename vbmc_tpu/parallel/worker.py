"""Sweep worker: one independent VBMC run per process.

Invoked by `parallel/launch.py` as
``python -m vbmc_tpu.parallel.worker payload.pkl out.npz``.
The payload pickle carries (fun, bounds, options); the output is a
serialized variational posterior with elbo/exitflag metadata — the slim
result `vbmc_diagnostics` consumes.

Honors VBMC_WORKER_PLATFORM=cpu|cuda (default: JAX's own choice) so a
smoke test can pin workers to CPU; on a GPU machine the launcher gives
each worker one card through CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import os
import pickle
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    in_path, out_path = argv[0], argv[1]
    repo = os.environ.get("VBMC_REPO")
    if repo and repo not in sys.path:
        sys.path.insert(0, repo)

    import jax
    platform = os.environ.get("VBMC_WORKER_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    if os.environ.get("VBMC_WORKER_X64", "0") == "1":
        jax.config.update("jax_enable_x64", True)

    with open(in_path, "rb") as f:
        payload = pickle.load(f)

    from vbmc_tpu.main import vbmc
    from vbmc_tpu.serialize import save_vp

    res = vbmc(payload["fun"], payload.get("x0"), payload.get("lb"),
               payload.get("ub"), payload.get("plb"), payload.get("pub"),
               options=payload["options"])
    save_vp(out_path, res.vp,
            metadata=dict(elbo=float(res.elbo), elbo_sd=float(res.elbo_sd),
                          exitflag=int(res.exitflag),
                          func_count=int(res.func_count),
                          iterations=int(res.iterations)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
