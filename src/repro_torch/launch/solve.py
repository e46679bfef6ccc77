"""D-iteration solve driver — the CLI over ``repro_torch.solve``.

The same flags as ``repro.launch.solve``, plus ``--device`` (default
``cuda``: the solve runs on the card unless the CPU is asked for) and
``-m`` for ``--method``.  Every run goes through the
:mod:`repro_torch.api` front door: a :class:`Problem` +
:class:`SolverOptions` + a registry ``--method`` key (or ``auto``).
Flag combinations are validated, never ignored: ``--k`` > 1,
``--dynamic`` and ``--policy`` need an engine method (``engine:chunk``,
``engine:bsr``; ``auto`` picks one for them); the engine's own flags
``--signal``, ``--buckets-per-dev`` and ``--verbose`` at any value but
their default are rejected unless the run is an engine run; the
``simulator`` method (``--simulate``) and ``--partition`` wait for the
simulator slice and are rejected.

  PYTHONPATH=src python -m repro_torch.launch.solve --n 20000
  PYTHONPATH=src python -m repro_torch.launch.solve --method frontier:pallas
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --k 4 \
      --dynamic -m engine:bsr
  PYTHONPATH=src python -m repro_torch.launch.solve --graph-file web.txt

``--graph-file`` loads a SNAP-style edge-list text file (``src dst``
per line, ``#`` comments) through :meth:`repro_torch.GraphStore.
from_edge_file`.
"""
import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Solve a synthetic PageRank instance through the "
        "repro_torch.api backend registry."
    )
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--graph", choices=["powerlaw", "web"], default="web")
    ap.add_argument("--graph-file", default=None,
                    help="SNAP-style edge-list file ('src dst' lines, "
                    "'#' comments) loaded via GraphStore.from_edge_file; "
                    "overrides --n/--graph")
    ap.add_argument("--weighted", action="store_true",
                    help="--graph-file has a third weight column")
    ap.add_argument("--target-error", type=float, default=None,
                    help="stopping target (default 1/N, paper §3.1)")
    ap.add_argument("-m", "--method", default="auto",
                    help="registry key (see repro_torch.list_backends()) or "
                    "'auto'")
    ap.add_argument("--simulate", action="store_true",
                    help="alias for --method simulator")
    ap.add_argument("--k", type=int, default=None,
                    help="PID/device count; validated against the chosen "
                    "backend (raises instead of being silently ignored)")
    ap.add_argument("--dynamic", action="store_true",
                    help="enable the §2.5.2 dynamic partition controller")
    ap.add_argument("--policy", default=None,
                    choices=["slope_ema", "cost_refresh", "hysteresis"],
                    help="rebalancing policy (implies --dynamic)")
    ap.add_argument("--signal", default="residual",
                    choices=["residual", "edge-ops"])
    ap.add_argument("--partition", default="uniform",
                    choices=["uniform", "cb"])
    ap.add_argument("--buckets-per-dev", type=int, default=8)
    ap.add_argument("--verbose", action="store_true",
                    help="engine progress, one line per chunk")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (cuda | cpu)")
    return ap


# flags only the engine reads, with their defaults: any other value needs
# an engine run
_ENGINE_FLAGS = {"signal": "residual", "buckets_per_dev": 8,
                 "verbose": False}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.simulate:
        if args.method not in ("auto", "simulator"):
            raise SystemExit(
                f"--simulate conflicts with --method {args.method!r}"
            )
        args.method = "simulator"
    if args.partition != "uniform":
        raise SystemExit(
            "inconsistent flags: --partition needs the simulator, which "
            "this port does not have yet")
    # auto picks an engine whenever k > 1 or the controller is on: only
    # the engine backends honor them
    engine_run = args.method.startswith("engine:") or (
        args.method == "auto"
        and ((args.k or 1) > 1 or args.dynamic or args.policy))
    for name, default in _ENGINE_FLAGS.items():
        if getattr(args, name) != default and not engine_run:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(
                f"inconsistent flags: {flag} needs the engine "
                "(--method engine:chunk | engine:bsr)")

    import repro_torch as repro
    from repro_torch.core import power_law_graph, webgraph_like

    if args.graph_file is not None:
        store = repro.GraphStore.from_edge_file(args.graph_file,
                                                weighted=args.weighted)
        g = store.csr()
        print(f"loaded {args.graph_file}: N={g.n} L={g.n_edges}")
    else:
        g = (power_law_graph(args.n, seed=0) if args.graph == "powerlaw"
             else webgraph_like(args.n, seed=1))
    problem = repro.Problem.pagerank(g, target_error=args.target_error)
    print(f"N={g.n} L={g.n_edges} target_error={problem.target_error:.2e}")

    options = repro.SolverOptions(
        k=args.k,
        dynamic=args.dynamic,
        policy=args.policy,
        signal=args.signal,
        buckets_per_dev=args.buckets_per_dev,
        verbose=args.verbose,
        device=args.device,
    )
    # validate the flag set up front so a rejected combination exits
    # cleanly, while genuine solver failures keep their tracebacks
    try:
        if args.method == "auto":
            options.validated()
        else:
            options.validated(repro.get_backend(args.method).caps,
                              args.method)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"inconsistent flags: {e}")
    report = repro.solve(problem, method=args.method, options=options)
    print(report.summary())
    if report.move_log:
        print(f"moves: {report.move_log[:8]}"
              f"{' ...' if len(report.move_log) > 8 else ''}")
    print("top-5:", np.argsort(-report.x)[:5].tolist())
    return report


if __name__ == "__main__":
    main()
