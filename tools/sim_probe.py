#!/usr/bin/env python3
"""Where the simulator's batch round spends its time, on one NVIDIA card.

    python3 tools/sim_probe.py [--n N] [--steps S] [--order uniform|out]
                               [--pushes] [--phase] [--runs R] [--src DIR]

Builds the port's kernels, then runs ``DistributedSimulator`` (K=8, the
batch schedule, target 1/N, ``host_block_graph(N, seed=0)`` in its own
order or by out-degree) for S time steps, twice on fresh simulators:

- untraced, after a short warm-up run: the wall, the rounds (each round
  of the batch schedule is one push: ``SimResult.n_pushes``) and the ms a
  round (the first round captures the sweep's CUDA graph, inside the
  window);
- under ``torch.profiler``: the host's and the kernels' time, in all and
  a round, the kernel launches a round, and the ops that took most of
  each.

``--pushes`` then replays a whole push (``_push``: K7's messages, their
sum, the s_k sums) at the largest and the median push (by messages) of
that window, 20 times each, and prints its device kernels and copies
(torch.profiler) and its stream time (CUDA events).  ``tools/k7_probe.py``
times K7's kernels alone at the same pushes.

``--phase`` then runs ``chip_smoke.py``'s phase 13 (``simulator_phase``)
alone at N, after the ``frontier:segment_sum`` solve it is held against,
and prints its lines and its K7 rows.

``--runs R`` instead runs the uniform static run (K=8, batch, target 1/N)
R times to convergence after a 3-step warm-up, printing each wall and its
counters, and nothing else; ``--src DIR`` imports ``repro_torch`` from
DIR (another checkout's ``src``, whose kernels build under that
checkout), so that two commits can be run in turns.  Prints the card's
name and power limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def capture_pushes(problem, steps, torch):
    """A fresh simulator run for ``steps`` steps at ``problem`` (K=8, batch,
    static) keeping every push's arguments: ``(sim, pushes)``, the pushes
    ``(sel, pid, sent, n_e, counts, remote)`` sorted by messages."""
    from repro_torch.core import DistributedSimulator

    pushes = []

    class Capturing(DistributedSimulator):
        def _push(self, sel, pid, sent, n_e, counts, remote):
            pushes.append((sel.clone(), pid.clone(), sent.clone(), n_e,
                           list(counts), list(remote)))
            super()._push(sel, pid, sent, n_e, counts, remote)

    sim = Capturing(problem.p, problem.b, _config(problem, steps))
    sim.run()
    torch.cuda.synchronize()
    return sim, sorted(pushes, key=lambda p: p[3])


def _config(problem, steps):
    from repro_torch.core import SimulatorConfig

    return SimulatorConfig(
        k=8, target_error=problem.target_error, eps=problem.eps,
        mode="batch", record_every=100, device="cuda", max_steps=steps)


def push_numbers(problem, steps, torch) -> None:
    """At the largest and the median push of ``steps`` steps: a whole push
    (``_push``: K7's messages, their sum, the s_k sums) replayed 20 times,
    its device kernels and copies under torch.profiler and its stream
    time by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DistributedSimulator

    sim, pushes = capture_pushes(problem, steps, torch)
    for what, push in (("largest", pushes[-1]),
                       ("median", pushes[len(pushes) // 2])):

        def one():  # the simulator's own push, not the capturing one
            DistributedSimulator._push(sim, *push)

        for _ in range(3):
            one()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                one()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            one()
        stop.record()
        torch.cuda.synchronize()
        print(f"{what} push ({push[0].numel()} nodes, {push[3]} messages): "
              f"{push_launches(prof) / 20:.1f} device kernels and copies a "
              f"push, {start.elapsed_time(stop) / 20:.4f} ms of stream time "
              "a push back to back; the device's time a push by kernel: "
              + ", ".join(f"{k[:40]} {ms / 20:.4f} ms" for ms, k in
                          push_kernels(prof)[:6]))


def push_kernels(prof):
    """[(device ms, name)] of the device's kernels and copies in a
    torch.profiler trace, the longest first."""
    from torch.autograd import DeviceType

    return sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
                    e.key) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  reverse=True)


def push_launches(prof) -> int:
    """Device kernels and copies in a torch.profiler trace."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**21)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--order", choices=("uniform", "out"), default="uniform")
    ap.add_argument("--pushes", action="store_true",
                    help="then a whole push at the window's largest and "
                    "median push")
    ap.add_argument("--phase", action="store_true",
                    help="then chip_smoke.py's phase 13 alone")
    ap.add_argument("--runs", type=int, default=0,
                    help="only R uniform static runs to convergence")
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    args = ap.parse_args()
    if args.src:  # before the first import of repro_torch
        sys.path.insert(0, args.src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sim_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import repro_torch
    from repro_torch.core import DistributedSimulator, host_block_graph
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
        sim = DistributedSimulator(problem.p, problem.b,
                                   _config(problem, steps))
        res = sim.run()
        torch.cuda.synchronize()
        return sim, res

    if args.runs:
        run(3)
        for _ in range(args.runs):
            t0 = time.perf_counter()
            _, res = run(2_000_000)
            print(f"run ({repro_torch.__file__}): wall "
                  f"{time.perf_counter() - t0:.3f} s, steps {res.n_steps}, "
                  f"edge ops {res.n_edge_ops}, pushes {res.n_pushes}, "
                  f"converged {res.converged}")
        print(f"on {smi}")
        return 0

    run(3)
    t0 = time.perf_counter()
    _, res = run(args.steps)
    wall = time.perf_counter() - t0
    rounds = res.n_pushes
    print(f"untraced: N={g.n} order {args.order}, {args.steps} steps, "
          f"{rounds} rounds, wall {wall:.3f} s, "
          f"{wall / max(rounds, 1) * 1e3:.3f} ms a round")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res = run(args.steps)
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunch")
                   and e.key != "cudaLaunchHostFunc")
    host = sum(e.self_cpu_time_total for e in events) / 1e3
    device = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events) / 1e3
    rounds = max(res.n_pushes, 1)
    print(f"traced: host {host:.1f} ms, kernels {device:.1f} ms; a round "
          f"host {host / rounds:.4f} ms, kernels {device / rounds:.4f} ms "
          f"({device / host:.4f} of the host's); {launches / rounds:.1f} "
          "kernel launches a round (graph launches among them "
          f"{sum(e.count for e in events if e.key == 'cudaGraphLaunch')})")
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cuda_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.pushes:
        push_numbers(problem, args.steps, torch)
    if args.phase:  # on the graph in its own order, as the smoke runs it
        dev = torch.device("cuda")
        g = host_block_graph(args.n, seed=0)
        problem = repro_torch.Problem.pagerank(g)
        x_ref = repro_torch.solve(problem, "frontier:segment_sum",
                                  device="cuda").x
        rows, summary = chip_smoke.simulator_phase(
            types.SimpleNamespace(device="cuda", seed=0, n=args.n), torch,
            dev, chip_smoke.Timer(torch, dev), g, problem, x_ref)
        print(summary)
        for row in rows:
            print(row)
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
