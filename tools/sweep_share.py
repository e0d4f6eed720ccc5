"""Share of the acquisition sweep in one warm `_propose_point` (candidate
generation -> 2^13-candidate sweep -> argmin -> CMA-ES), and where that
program's device time goes.

The share is taken on the host clock: the sweep alone
(`evaluate_acquisition`) against the whole program, each ended by
`block_until_ready`. A `jax.profiler` trace of one program call gives its
total kernel time, busy time and the kernels that take the most time.
(On the GPU, XLA replays runs of small kernels as CUDA graphs, which the
trace names `command_buffer`; kernels inside one cannot be told apart.)

Usage: python tools/sweep_share.py TRACE_DIR
Shapes are bench_kernels.py's: D=6, N=256, S=16, K=16, M=8192.
"""

import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def reduce_trace(xplane_path: str, module: str) -> dict:
    """Kernel time of ``module`` on the device planes: total, the busy
    interval union and the ten costliest kernels, in seconds."""
    from jax.profiler import ProfileData
    total = 0.0
    spans = []
    lines_seen = {}
    per_op = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            n_ev = 0
            for ev in line.events:
                stats = dict(ev.stats)
                if stats.get("hlo_module", "").find(module) < 0:
                    continue
                if line.name in ("XLA Modules", "XLA Ops", "Steps"):
                    continue
                n_ev += 1
                d = ev.duration_ns * 1e-9
                total += d
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                op = stats.get("hlo_op", ev.name)
                per_op[op] = per_op.get(op, 0.0) + d
            lines_seen[f"{plane.name}:{line.name}"] = n_ev
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) * 1e-9
            end = b
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernel_s=total, busy_s=busy, lines=lines_seen, top_ops=top)


def main():
    import jax
    import bench_kernels
    from vbmc_tpu.main import _configure_numerics
    from vbmc_tpu.acquisitions import evaluate_acquisition
    from vbmc_tpu.active_sample import _propose_point
    from vbmc_tpu.options import VBMCOptions

    out_dir = sys.argv[1]
    _configure_numerics()
    dev = jax.devices()[0]
    hp = bench_kernels.host_problem()
    p = bench_kernels.device_problem(hp)
    cfg, gp, vp, Xs, state = p["cfg"], p["gp"], p["vp"], p["Xs"], p["state"]
    D = hp["D"]
    o = VBMCOptions().resolve(D)
    ns = o.ns_search
    sb_lb = jax.numpy.full((D,), -4.0, dtype=gp.X.dtype)
    args = (cfg, "prospective", jax.random.PRNGKey(0), None, vp, gp, state,
            sb_lb, -sb_lb)
    kw = dict(n_search=ns, n_heavy=int(round(o.heavy_tail_search_frac * ns)),
              n_mvn=int(round(o.mvn_search_frac * ns)),
              n_box=int(round(o.box_search_frac * ns)),
              max_evals=o.search_max_fun_evals,
              popsize=o.search_cmaes_popsize, smooth=False, refine=True)

    def propose(i):
        a = list(args)
        a[3] = jax.numpy.asarray(i, dtype=jax.numpy.int32)
        return _propose_point(*a, **kw)

    t_prog = bench_kernels.time_call(propose, reps=5)
    t_sweep = bench_kernels.time_call(
        lambda i: evaluate_acquisition(cfg, "prospective", Xs + i * 1e-6,
                                       vp, gp, state))
    jax.profiler.start_trace(out_dir)
    jax.block_until_ready(propose(99))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    res = reduce_trace(path, "_propose_point")
    res.update(device=dev.device_kind, card=bench_kernels.card_info(),
               host_program_s=t_prog, host_sweep_alone_s=t_sweep,
               host_sweep_share=t_sweep / t_prog, max_evals=o.search_max_fun_evals, n_search=ns)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
