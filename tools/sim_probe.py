#!/usr/bin/env python3
"""Where the simulator's batch round spends its time, on one NVIDIA card.

    python3 tools/sim_probe.py [--n N] [--steps S] [--order uniform|out]
                               [--phase]

Builds the port's kernels, then runs ``DistributedSimulator`` (K=8, the
batch schedule, target 1/N, ``host_block_graph(N, seed=0)`` in its own
order or by out-degree) for S time steps, twice on fresh simulators:

- untraced, after a short warm-up run: the wall, the rounds (each round
  of the batch schedule is one push: ``SimResult.n_pushes``) and the ms a
  round (the first round captures the sweep's CUDA graph, inside the
  window);
- under ``torch.profiler``: the host's and the kernels' time, the kernel
  launches a round, and the ops that took most of each.

``--phase`` then runs ``chip_smoke.py``'s phase 13 (``simulator_phase``)
alone at N, after the ``frontier:segment_sum`` solve it is held against,
and prints its lines and its K7 rows.  Prints the card's name and power
limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**21)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--order", choices=("uniform", "out"), default="uniform")
    ap.add_argument("--phase", action="store_true",
                    help="then chip_smoke.py's phase 13 alone")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sim_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import repro_torch
    from repro_torch.core import (
        DistributedSimulator, SimulatorConfig, host_block_graph)
    from repro_torch.kernels import _build
    from torch.profiler import ProfilerActivity, profile

    smi = chip_smoke.nvidia_smi()
    print(f"device: {smi}")
    for name in _build.build_all():
        _build.library(name)
    g = host_block_graph(args.n, seed=0)
    if args.order == "out":
        g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    problem = repro_torch.Problem.pagerank(g)

    def run(steps):
        sim = DistributedSimulator(problem.p, problem.b, SimulatorConfig(
            k=8, target_error=problem.target_error, eps=problem.eps,
            mode="batch", record_every=100, device="cuda",
            max_steps=steps))
        res = sim.run()
        torch.cuda.synchronize()
        return res

    run(3)
    t0 = time.perf_counter()
    res = run(args.steps)
    wall = time.perf_counter() - t0
    rounds = res.n_pushes
    print(f"untraced: N={g.n} order {args.order}, {args.steps} steps, "
          f"{rounds} rounds, wall {wall:.3f} s, "
          f"{wall / max(rounds, 1) * 1e3:.3f} ms a round")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run(args.steps)
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    host = sum(e.self_cpu_time_total for e in events) / 1e3
    device = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events) / 1e3
    print(f"traced: host {host:.1f} ms, kernels {device:.1f} ms, "
          f"{launches / max(res.n_pushes, 1):.1f} kernel launches a round "
          f"(and {sum(e.count for e in events if e.key == 'cudaGraphLaunch')}"
          " graph launches)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cuda_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.phase:  # on the graph in its own order, as the smoke runs it
        dev = torch.device("cuda")
        g = host_block_graph(args.n, seed=0)
        problem = repro_torch.Problem.pagerank(g)
        x_ref = repro_torch.solve(problem, "frontier:segment_sum",
                                  device="cuda").x
        rows, summary = chip_smoke.simulator_phase(
            types.SimpleNamespace(device="cuda", seed=0), torch, dev,
            chip_smoke.Timer(torch, dev), g, problem, x_ref)
        print(summary)
        for row in rows:
            print(row)
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
