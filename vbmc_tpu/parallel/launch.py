"""Multi-process dispatch for independent VBMC runs.

The multi-run validation workflow (`vbmc_diagnostics.m`) is embarrassingly
parallel at the RUN level: each run is an independent inference with its
own seed, and only the final (vp, elbo, elbo_sd) triples meet for
cross-validation. This module dispatches each run to its OWN PROCESS, then
gathers the slim results for diagnostics:

- one worker process per run (`python -m vbmc_tpu.parallel.worker`), each
  with an isolated JAX runtime. On a machine with NVIDIA cards each worker
  gets one card (``CUDA_VISIBLE_DEVICES``), and at most one worker runs on
  a card at a time: a JAX process reserves most of a card's memory, so a
  second one on the same card fails. The other runs queue. ``env_per_run``
  overrides the card choice; ``launcher`` wraps the command (e.g.
  ``["ssh", "host3"]`` / an mpirun prefix);
- run payloads cross the process boundary by pickle (the target callable
  and any callable options must be picklable, i.e. module-level);
- results return as serialized variational posteriors + scalar stats
  (`serialize.save_vp`), which is exactly what `vbmc_diagnostics` needs.

WITHIN each run, multi-device scaling is the in-loop sharding path
(`parallel/context.py` — hyp-ensemble/sieve/candidate axes over the local
mesh); ACROSS runs, this module is the scale-out axis. VBMC's problem sizes
(D <= 20, N <= 1024) make per-run multi-HOST compute unprofitable, so the
supported multi-host story is run-parallelism.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np


def visible_cards(environ=os.environ) -> list:
    """Ids of the NVIDIA cards a worker may be given, found without
    initialising JAX: ``CUDA_VISIBLE_DEVICES`` when set, otherwise the
    cards ``nvidia-smi -L`` lists; empty on a machine without cards."""
    vis = environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except FileNotFoundError:
        return []
    if out.returncode != 0:
        return []
    return [str(i) for i, line in enumerate(out.stdout.splitlines())
            if line.startswith("GPU ")]


def plan_runs(n_runs: int, cards: Sequence[str]) -> list:
    """Queues of run indices, one queue per worker slot, and the card of
    each slot: ``[(card, [run, ...]), ...]``. With cards, run i goes to
    card ``i % len(cards)`` and each card runs its queue one run at a time;
    without cards every run gets its own slot (card None) and all start at
    once."""
    if not cards:
        return [(None, [i]) for i in range(n_runs)]
    return [(card, list(range(k, n_runs, len(cards))))
            for k, card in enumerate(cards) if k < n_runs]


def dispatch_runs(fun, x0=None, lb=None, ub=None, plb=None, pub=None,
                  options=None, n_runs: int = 3,
                  python: Optional[str] = None,
                  launcher: Optional[Sequence[str]] = None,
                  env_per_run: Optional[Sequence[dict]] = None,
                  timeout: float = 3600.0, workdir: Optional[str] = None):
    """Run ``n_runs`` independent VBMC inferences in separate processes.

    Returns (DiagnosticsResult, [(vp, elbo, elbo_sd, meta), ...]).
    Seeds are ``options.seed + 1000*i`` (same schedule as the sequential
    `vbmc_sweep`).
    """
    from vbmc_tpu.options import VBMCOptions
    from vbmc_tpu.serialize import load_vp
    from vbmc_tpu.diagnostics import vbmc_diagnostics

    if options is None:
        options = VBMCOptions()
    python = python or sys.executable
    tmp = tempfile.mkdtemp(prefix="vbmc_sweep_", dir=workdir)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmds, envs, out_paths = [], [], []
    for i in range(n_runs):
        opts_i = dataclasses.replace(options, seed=options.seed + 1000 * i)
        in_path = os.path.join(tmp, f"run{i}.pkl")
        out_paths.append(os.path.join(tmp, f"run{i}_out.npz"))
        with open(in_path, "wb") as f:
            pickle.dump(dict(fun=fun, x0=x0, lb=lb, ub=ub, plb=plb, pub=pub,
                             options=opts_i), f)
        cmds.append(list(launcher or []) + [
            python, "-m", "vbmc_tpu.parallel.worker", in_path, out_paths[i]])
        env = dict(os.environ)
        env["VBMC_REPO"] = repo          # the repo must be importable
        envs.append(env)

    def run_queue(card, runs):
        failed = []
        for i in runs:
            env = envs[i]
            if card is not None:
                env["CUDA_VISIBLE_DEVICES"] = card
            if env_per_run is not None and i < len(env_per_run):
                env.update(env_per_run[i])
            try:
                rc = subprocess.run(cmds[i], env=env,
                                    timeout=timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((i, rc))
        return failed

    plan = plan_runs(n_runs, visible_cards())
    with ThreadPoolExecutor(max_workers=max(len(plan), 1)) as ex:
        failures = sorted(f for fs in ex.map(lambda q: run_queue(*q), plan)
                          for f in fs)
    if failures:
        raise RuntimeError(f"sweep workers failed: {failures}")

    triples = []
    metas = []
    for path in out_paths:
        vp, meta = load_vp(path)
        triples.append((vp, float(meta["elbo"]), float(meta["elbo_sd"])))
        metas.append(meta)
    diag = vbmc_diagnostics(triples)
    return diag, [t + (m,) for t, m in zip(triples, metas)]
