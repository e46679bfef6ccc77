"""CLI: ``python -m repro_torch.kernels.tune [--kernel K] [--smoke]``.

Sweeps K1 (``frontier_round_bsr``) and K2 (``bsr_gather_spmm``) over
block size and tile-ring depth on the card (``--device cuda``, the
default) or their plain versions on the CPU (``--device cpu``), prints
each row and the winner, and writes the winning config record under
``$REPRO_TORCH_TUNE_DIR`` (default ``results/tuned_torch/``) unless
``--no-save``.  ``--smoke`` runs the tiny sweep (n=1024, bs in {32, 64},
depths {1, 2}, 1 iteration).
"""
from __future__ import annotations

import argparse
import json

from . import records, run_sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels.tune")
    ap.add_argument("--kernel", default="all",
                    choices=("all",) + records.KERNELS)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep (n=1024, bs in {32,64}, 1 iter)")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--c", type=int, default=1)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): time the kernels; cpu: time "
                    "the plain versions")
    args = ap.parse_args(argv)

    kw = dict(n=args.n, c=args.c, density=args.density, iters=args.iters,
              seed=args.seed, save=not args.no_save, device=args.device)
    if args.smoke:
        kw.update(n=1024, bs_list=(32, 64), depths=(1, 2), iters=1)
    kernels = records.KERNELS if args.kernel == "all" else (args.kernel,)
    for kernel in kernels:
        rec = run_sweep(kernel, **kw)
        print(json.dumps(rec["best"], indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
