#!/usr/bin/env python3
"""Where K3's lane form (``edge_sum_lanes``) spends its time, on one NVIDIA
card.

    python3 tools/k3_lanes_probe.py [--against FILE ...] [--n N]
                                    [--lanes 1,4,16,32] [--iters 20]
                                    [--graphs host,permuted]
                                    [--serve RUNS]

Builds ``src/repro_torch/csrc/edge_sum.cu`` as it is ("base") and each
``--against`` file (another ``edge_sum.cu`` with the same C interface,
such as a parent commit's: ``git show
HEAD~1:src/repro_torch/csrc/edge_sum.cu``, or a variant of the base with
another layout of its gathers), all nvcc runs in parallel; prints each
build's registers and shared memory and the blocks an SM that they
allow.  Then, on the batched round's graph
(``host_block_graph(N, seed=0)``'s PageRank edges, as ``chip_smoke.py``
phase 14 builds them) and on the same graph under a random node
permutation (no locality left between a destination and its sources),
for each lane count C:

- every build's result held to the base build's bits, and the base
  build's every lane to K3 launched on its row (``torch.equal``);
- each build's launch, the package's wrapper (what the smoke times) and
  ``torch.sparse.mm`` (sparse_csr over the destination CSR, ``[N, C]``
  dense) timed by CUDA events in turns: the least of two ``--iters``-call
  means, the second round in reverse order, the greatest in brackets;
  beside the bound (each input byte read once, each output byte written
  once, over 3.35 TB/s).  The base's one phase is its gather kernel: the
  launch's time is that phase, and the wrapper's time beside it adds the
  host's checks and allocation.

With ``--serve RUNS``, then times what the lane form serves, on the
host-ordered graph's PageRank problem, with the package's build and with
the first ``--against`` build in turns (package, against, against,
package, ... RUNS pairs): ``SolverSession.solve_batch`` on 16 columns
(the smoke's phase 14 (b): B drifted 2 %) and the continuous-batching
``Scheduler`` (16 lanes, 32 rounds a tick) serving 24 requests over 8
clusters in three waves (phase 14 (c) without its graph update), each
held to the first run's rounds and pushes.  It prints each run's walls,
ms a batched round, rounds and QPS on the host wall, and exits non-zero
if a run's counts differ.

Prints the card's name and power limit first and last; exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUT = ROOT / "build" / "k3_lanes_probe"
SM_REGS, SM_SMEM, SM_THREADS = 65536, 233472, 2048  # an H100 SM


def build(name, source, defines=()):
    """nvcc of ``source`` into OUT/name/lib.so with ``defines``; returns
    (name, exit code, ptxas lines of the lane-form kernels)."""
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "edge_sum.cu").write_text(pathlib.Path(source).read_text())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines,
                           "-o", str(d / "lib.so"), str(d / "edge_sum.cu")],
                          capture_output=True, text=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    keep, kernel = [], None
    for ln in lines:
        if "error" in ln:
            keep.append(ln.strip())
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kernel = m.group(1)
        if "Used" in ln and kernel and "lanes" in kernel:
            keep.append(f"{kernel}: {ln.strip()}")
    return name, proc.returncode, keep


def blocks_an_sm(ptxas_line, threads=256):
    """Resident blocks an SM that a kernel's registers and shared memory
    allow at ``threads`` a block."""
    regs = int(re.search(r"Used (\d+) registers", ptxas_line).group(1))
    m = re.search(r"(\d+) bytes smem", ptxas_line)
    smem = int(m.group(1)) if m else 0
    by_regs = SM_REGS // (((regs * 32 + 255) // 256 * 256) * (threads // 32))
    by_smem = SM_SMEM // (smem + 1024) if smem else 32
    return min(by_regs, by_smem, SM_THREADS // threads)


def launcher(lib, torch):
    """A function ``(x, edges) -> out`` launching ``lib``'s lane form on
    the current stream; also types ``lib``'s K3 as the package's wrapper
    does, so that ``lib`` can stand in for the package's library."""
    from repro_torch.kernels import _build

    p = ctypes.c_void_p
    lib.edge_sum.argtypes = [p] * 5 + [ctypes.c_int64, p]
    lib.edge_sum.restype = ctypes.c_int
    lib.edge_sum_lanes.argtypes = [p] * 5 + [ctypes.c_int64] * 3 + [p]
    lib.edge_sum_lanes.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p

    def run(x, e):
        lanes = x.shape[0]
        out = torch.empty((lanes, e.n), dtype=torch.float32, device=x.device)
        err = lib.edge_sum_lanes(e.indptr.data_ptr(), e.src.data_ptr(),
                                 e.wgt.data_ptr(), x.data_ptr(),
                                 out.data_ptr(), e.n, e.x_len, lanes,
                                 _build.stream_handle(x.device))
        _build.check(lib, err, "edge_sum_lanes")
        return out

    return run


def serve(torch, args, against_lib, device="cuda"):
    """``--serve``: the batched solve and the scheduler on the package's
    lane form and on ``against_lib``'s, in turns (``device="cpu"``
    rehearses the control flow on the plain versions).  Returns 0 when
    every run's counts equal the first run's, else 1."""
    import numpy as np

    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.edge_sum import kernel as k3
    from repro_torch.serving import Scheduler

    problem = repro_torch.Problem.pagerank(host_block_graph(args.n, seed=0))
    rng = np.random.default_rng(14)
    n = problem.n
    cols = np.abs(problem.b[:, None] * (1.0 + 0.02 * rng.standard_normal((n, 16))))
    waves = [list(range(8)) * 2, list(range(8))]
    reqs = [[np.abs(cols[:, c] * (1.0 + 0.02 * rng.standard_normal(n)))
             for c in wave] for wave in waves]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    package_lib = k3._lib
    libs = {"package": k3._lib() if on_card else None,
            "against0": against_lib}
    counts = {}
    order = ["package", "against0", "against0", "package"] * args.serve
    try:
        for name in order:
            k3._lib = lambda lib=libs[name]: lib
            reset_launches()
            session = repro_torch.SolverSession(
                problem, "frontier:segment_sum", device=device)
            sync()
            t0 = time.perf_counter()
            rep = session.solve_batch(cols)
            solve_s = time.perf_counter() - t0
            del session
            sch = Scheduler(problem, max_lanes=16, rounds_per_tick=32,
                            device=device)
            t0 = time.perf_counter()
            rid = 0
            for wave, bs in zip(waves, reqs):
                for cluster, b in zip(wave, bs):
                    sch.submit(b, cluster=cluster, request_id=rid)
                    rid += 1
                sch.run_until_idle()
            sync()
            sch_s = time.perf_counter() - t0
            got = (rep.n_rounds, rep.n_ops, sch.batcher.rounds_total,
                   sch.batcher.ops_total, len(sch.results))
            same = counts.setdefault("counts", got) == got
            counts["differ"] = counts.get("differ", False) or not same
            print(f"{name}: solve_batch C=16 {solve_s:.3f} s, "
                  f"{rep.n_rounds} rounds ({solve_s * 1e3 / rep.n_rounds:.4f} "
                  f"ms a batched round); scheduler {sch_s:.3f} s, "
                  f"{sch.batcher.rounds_total} rounds, {len(sch.results)} "
                  f"served (QPS {len(sch.results) / sch_s:.3f}); lane-form "
                  f"launches {LAUNCHES['edge_sum_lanes']}; counts equal to "
                  f"the first run's {same}", flush=True)
            del sch
    finally:
        k3._lib = package_lib
    return 1 if counts.get("differ") else 0


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_sum import csc_edges, edge_sum, edge_sum_lanes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another edge_sum.cu to build and time")
    ap.add_argument("--n", type=int, default=2**21)
    ap.add_argument("--lanes", default="1,4,16,32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--graphs", default="host,permuted")
    ap.add_argument("--serve", type=int, default=0,
                    help="pairs of serving runs, package and --against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_lanes_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    base = _build.CSRC / "edge_sum.cu"
    builds = {"base": (base, ()),
              **{f"against{i}": (f, ()) for i, f in enumerate(args.against)}}
    with cf.ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda n: build(n, *builds[n]), builds))
    for name, rc, lines in built:
        print(f"{name} ({builds[name][0]} {' '.join(builds[name][1])}): nvcc "
              f"exit {rc}" + "".join(
                  f"\n  {ln}" + (f" -> {blocks_an_sm(ln)} blocks of 256 an SM "
                                 "by registers and static shared memory"
                                 if "Used" in ln else "") for ln in lines))
    if any(rc for _, rc, _ in built):
        return 1
    runs, libs = {}, {}
    for name in builds:
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
        runs[name] = launcher(libs[name], torch)
    dev = torch.device("cuda")
    timer = chip_smoke.Timer(torch, dev)

    t0 = time.perf_counter()
    problem = repro_torch.Problem.pagerank(host_block_graph(args.n, seed=0))
    n = problem.n
    src, dst, wgt = problem.p.edge_list()
    perm = np.random.default_rng(1).permutation(n)
    graphs = {}
    if "host" in args.graphs:
        graphs["host order"] = csc_edges(src, dst, wgt, n, dev)
    if "permuted" in args.graphs:
        graphs["permuted"] = csc_edges(perm[src], perm[dst], wgt, n, dev)
    print(f"set-up {time.perf_counter() - t0:.1f} s: N {n}, "
          f"{src.size} edges")
    rng = np.random.default_rng(14)
    rc = 0
    for gname, e in graphs.items():
        a_csr = torch.sparse_csr_tensor(e.indptr, e.src.long(), e.wgt,
                                        size=(n, n))
        for c in [int(v) for v in args.lanes.split(",") if v]:
            x = torch.as_tensor(rng.standard_normal((c, n)) / n,
                                dtype=torch.float32, device=dev)
            xt = x.T.contiguous()
            want = runs["base"](x, e)
            k3 = all(torch.equal(want[lane], edge_sum(x[lane].contiguous(), e))
                     for lane in range(c))
            same = {k: torch.equal(run(x, e), want) for k, run in runs.items()}
            fns = {k: (lambda run=run: run(x, e)) for k, run in runs.items()}
            fns["wrapper"] = lambda: edge_sum_lanes(x, e)
            fns["sparse.mm"] = lambda: torch.sparse.mm(a_csr, xt)
            t = chip_smoke.least(timer, fns, args.iters)
            n_bytes = e.indptr.numel() * 8 + e.n_edges * 8 + 2 * c * n * 4
            b_ms, b_by = chip_smoke.bound_ms(n_bytes, 2.0 * e.n_edges * c)
            print(f"{gname} C={c}: base lanes K3's bits {k3}; bits equal to "
                  f"base {same}; bound {b_ms:.4f} ms ({b_by}); " + ", ".join(
                      f"{k} {lo:.4f} [{hi:.4f}]" for k, (lo, hi) in t.items())
                  + " ms")
            rc |= not k3
            del x, xt, want
    if args.serve and args.against:
        rc = serve(torch, args, libs["against0"])
    print(f"on {smi}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
