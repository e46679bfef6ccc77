#!/usr/bin/env python3
"""Where K1 (the fused frontier round) spends its time, on one NVIDIA card.

    python3 tools/k1_probe.py [VARIANT ...] [--n N] [--json PATH]

Builds ``src/repro_torch/csrc/diffusion.cu`` once as it is ("base") and
once per named variant below, each a list of source edits (every edit
must find its text, or the tool stops), all nvcc runs in parallel; loads
each build in turn in place of the wrapper's library and times its K1
(CUDA events, ``chip_smoke.Timer``; ``chip_smoke.least``: the least of
two rounds, the second in reverse order, the greatest in brackets) at
two inputs of
``chip_smoke.py``, both on the seed-0 ``host_block_graph(N)`` tile pool
at bs=128, C=1 (N = 2**21: 81,907 tiles of 64 KiB):

- ``a``: phase 11's timing input, phase 3's first random fluid at its
  median threshold (95 % of the tiles armed at N = 2**21);
- ``b``: a late round, the operands of round 3,001 of the
  ``frontier:pallas`` cold solve (``chip_smoke.late_round``);
- ``c``: the sparsest round of that solve that reads a tile, and ``e``
  its first round that reads none (if any), from a census: one cold
  solve on the base build and one on the ``simt`` build under
  torch.profiler, every K1 launch's device time summed by its round's
  armed tile share, beside the device's busy share of the traced wall;

beside K2's bulk ``bsr_spmm`` over the same pool (every tile) and
``torch.sum`` over the pool (the card's streaming read rate), with the
bytes bound, the achieved TB/s and each input's armed share.  Every
variant but ``bare`` must give the base build's bits.  Then the cold
``frontier:pallas`` solve on the base build and on the ``simt`` build,
in turns (base, simt, simt, base): wall and rounds.

Variants (the base: the bulk body, two CTAs an SM, each with a producer
warp that tests 32 tiles at once and eight consumer warps, a ring of 3
stages of 32 KiB slabs): ``simt`` (a build whose route rule always picks
the simt body, a CTA per output row); ``stages2`` (2 stages); ``cta1``
(one CTA an SM); ``serial_scan`` (the producer tests one tile at a time:
what the ballot scan saves); ``bare`` (the copies, barriers and epilogue
with no tile arithmetic: the design's own floor).  With no argument, all
of them.  ``--json PATH`` writes every number there too.  Prints the
card's name and power limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_MATH = """        accumulate_slab<true>(ring + (size_t)st * sr * bs, x_s, acc_s, row0, min(sr, bs - row0), bs,
                              C, warp, lane, x_s + m);
"""
_BULK_RULE = ("  if (bs % 4 == 0 && aligned && frontier_bulk_smem(bs, C) <= kMaxSmem) "
              "return kRouteBulk;\n")

# name: (source edits, route)
VARIANTS = {
    "simt": ([(_BULK_RULE, "")], "simt"),
    "stages2": ([("constexpr int kBulkStages = 3;",
                  "constexpr int kBulkStages = 2;")], "bulk"),
    "cta1": ([("constexpr int kCtasPerSm = 2;",
               "constexpr int kCtasPerSm = 1;")], "bulk"),
    "serial_scan": ([("constexpr int kScanLanes = 32;",
                      "constexpr int kScanLanes = 1;")], "bulk"),
    "bare": ([(_MATH, "")], "bulk"),
}
OUT = ROOT / "build" / "k1_probe"
# the census's buckets of the armed tile share: (name, upper end)
CENSUS_BUCKETS = (("0", 0.0), ("(0, 1%]", 0.01), ("(1, 10%]", 0.1),
                  ("(10, 50%]", 0.5), ("(50, 90%]", 0.9),
                  ("(90, 100%]", 1.0))


def edited_source(name, edits):
    """diffusion.cu with a variant's edits; stops if one misses its text."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "diffusion.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k1_probe: {name}: no {old!r} in diffusion.cu")
        src = src.replace(old, new)
    return src


def build(name, edits):
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "diffusion.cu").write_text(edited_source(name, edits))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "diffusion.cu")],
                          capture_output=True, text=True)
    errors = [ln for ln in (proc.stdout + proc.stderr).splitlines()
              if "error" in ln]
    return name, proc.returncode, errors


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import (
        BS, HBM_BYTES_PER_S, Timer, armed_tiles, k1_bytes, k1_operands,
        late_round, least, median_threshold, nvidia_smi, random_fluid)
    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels.diffusion import kernel as k1

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of them")
    ap.add_argument("--n", type=int, default=2**21,
                    help="nodes of the host_block_graph (default 2**21)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    wanted = args.variants or list(VARIANTS)
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        print(f"k1_probe: no variant {sorted(unknown)}; there are "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    variants = {"base": ([], "bulk"), **{n: VARIANTS[n] for n in wanted}}
    with cf.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda n: build(n, variants[n][0]), variants))
    for name, rc, errors in built:
        print(f"{name}: nvcc exit {rc}" + "".join(f"\n  {e}" for e in errors))
    if any(rc for _, rc, _ in built):
        return 1

    own_lib = k1._lib
    real = own_lib()
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fname in ("frontier_round_bsr", "frontier_round_bsr_route",
                      "bsr_spmm", "bsr_spmm_route"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    @contextlib.contextmanager
    def on(name):
        """The wrapper's kernels from the build of ``name``."""
        k1._lib = lambda: libs[name]
        try:
            yield
        finally:
            k1._lib = own_lib

    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    t0 = time.perf_counter()
    g = host_block_graph(args.n, seed=0)
    problem = repro_torch.Problem.pagerank(g)
    m = problem.graph.bsr(BS).to_device(dev)
    n_pad = m.n_row_blocks * BS
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[: g.n] = torch.as_tensor(problem.node_weights(), dtype=torch.float32,
                               device=dev)
    f = random_fluid(torch, np.random.default_rng(0), g.n, n_pad, 1, dev)
    inputs = {"a": k1_operands(torch, m, f, w, median_threshold(torch, f, w),
                               0.0)}
    inputs["b"], late = late_round(torch, repro_torch, problem, "cuda")
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s (input b after {late} "
          "rounds)")

    def census(name):
        """A cold frontier:pallas solve on the build ``name`` under
        torch.profiler, with each round's armed tiles counted (a host sync
        a round: the solve syncs every round anyway).  Prints each K1
        launch's device time summed by armed tile share and the device's
        busy share of the traced wall.  Returns ``({bucket: [rounds, K1
        ms]}, the operands of the sparsest round that reads a tile, of the
        first round that reads none)``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels.diffusion import ops

        real = ops.frontier_round_bsr_kernel
        seen, keep = [], {}

        def counted(*ins, **kw):
            out = real(*ins, **kw)
            tiles = armed_tiles(ins[3], ins[1])
            seen.append(tiles)
            kept = ins[:3] + tuple(t.clone() for t in ins[3:])
            if tiles == 0:
                keep.setdefault("empty", kept)
            elif tiles < keep.get("sparse_tiles", len(ins[1]) + 1):
                keep.update(sparse=kept, sparse_tiles=tiles)
            return out

        with on(name):  # the module's first launch, out of the trace
            k1.launch_frontier_round_bsr(*inputs["a"])
        ops.frontier_round_bsr_kernel = counted
        try:
            with on(name), profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                repro_torch.solve(problem, method="frontier:pallas",
                                  device="cuda")
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
        finally:
            ops.frontier_round_bsr_kernel = real
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        k1_ms = [e.time_range.elapsed_us() / 1e3 for e in sorted(
            (e for e in events if "frontier_round" in e.name),
            key=lambda e: e.time_range.start)]
        if len(k1_ms) != len(seen):
            print(f"census on {name}: {len(k1_ms)} K1 kernels traced in "
                  f"{len(seen)} rounds: device times not measured")
            return {}, keep.get("sparse"), keep.get("empty")
        n_tiles = m.block_col.numel()
        buckets = {}
        for tiles, ms in zip(seen, k1_ms):
            key = next(k for k, hi in CENSUS_BUCKETS
                       if tiles / n_tiles <= hi)
            got = buckets.setdefault(key, [0, 0.0])
            got[0] += 1
            got[1] += ms
        print(f"census of the cold solve on {name}: {len(seen)} rounds, "
              f"traced wall {wall:.1f} ms, device kernels {busy:.1f} ms "
              f"({100 * busy / wall:.1f} %), K1 {sum(k1_ms):.1f} ms; K1 by "
              "armed tile share: " + "; ".join(
                  f"{k} {n} rounds {ms:.3f} ms ({ms / n:.4f} a round)"
                  for k, hi in CENSUS_BUCKETS if k in buckets
                  for n, ms in [buckets[k]]) + f" on {smi}", flush=True)
        return buckets, keep.get("sparse"), keep.get("empty")

    censuses = {}
    for name in ("base", "simt"):
        if name in libs:
            censuses[name], sparse, empty = census(name)
            if name == "base":
                inputs["c"] = sparse
                if empty is not None:
                    inputs["e"] = empty
    inputs = {k: v for k, v in inputs.items() if v is not None}

    x = torch.rand((m.n_row_blocks, BS, 1),
                   generator=torch.Generator(dev).manual_seed(0), device=dev)
    k2_ins = (m.blocks, m.visit_block, m.block_col, m.row_ptr, x)
    k2_bytes = (m.blocks.numel() * 4 + m.visit_block.numel() * 8
                + m.row_ptr.numel() * 8 + x.numel() * 4 * 2)
    pool_bytes = m.blocks.numel() * 4
    result = {"device": smi, "n": args.n, "late_rounds": late,
              "census": censuses, "inputs": {}}
    for iname, ins in inputs.items():
        _, block_col, _, col_active, f3, _ = ins
        nrb = f3.shape[0]
        tiles = armed_tiles(col_active, block_col)
        n_bytes = k1_bytes(ins)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        share = tiles / block_col.numel()
        print(f"== input {iname}: {int(col_active.sum())}/{nrb} block "
              f"columns armed, {tiles}/{block_col.numel()} tiles armed "
              f"({share:.4f} of the pool, {tiles * BS * BS * 4 / 1e9:.3f} "
              "GB)")

        def run(name, ins=ins):
            with on(name):
                return k1.launch_frontier_round_bsr(
                    *ins, route=variants[name][1])

        base = run("base")
        for name in variants:
            got = run(name)
            same = (torch.equal(got[0], base[0])
                    and torch.equal(got[1], base[1]))
            print(f"input {iname} {name}: route {got[2]}, bit-identical to "
                  f"base {same}")
            if name != "bare" and not same:
                raise SystemExit(f"k1_probe: input {iname} {name} changes "
                                 "bits")
            del got
        del base
        fns = {name: (lambda name=name: run(name)) for name in variants}
        fns["k2_bulk"] = lambda: k1.launch_bsr_spmm(*k2_ins, route="bulk")
        fns["read"] = lambda: m.blocks.sum()
        times = least(timer, fns, 10)
        k2_ms, read_ms = times["k2_bulk"][0], times["read"][0]
        result["inputs"][iname] = {
            "armed_columns": int(col_active.sum()), "armed_tiles": tiles,
            "armed_tile_fraction": share, "bytes": n_bytes,
            "bound_ms": b_ms, "times": times}
        print(f"== input {iname}: bound {b_ms:.4f} ms ({n_bytes / 1e9:.3f} "
              f"GB); K2 bulk over the pool {k2_ms:.4f} ms "
              f"[{times['k2_bulk'][1]:.4f}] ({k2_bytes / k2_ms / 1e9:.3f} "
              f"TB/s); torch.sum over the {pool_bytes / 1e9:.3f} GB pool "
              f"{read_ms:.4f} ms [{times['read'][1]:.4f}] "
              f"({pool_bytes / read_ms / 1e9:.3f} TB/s) on {smi}")
        for name in variants:
            t, worst = times[name]
            print(f"  {name}: {t:.4f} ms [{worst:.4f}] {n_bytes / t / 1e9:.3f}"
                  f" TB/s  x{t / b_ms:.3f} bound, x{t / k2_ms:.3f} K2 bulk",
                  flush=True)
        torch.cuda.empty_cache()
    del inputs

    # the cold solve on the base build and on one whose rule picks simt
    solves = {"base": [], "simt": []}
    for name in ("base", "simt", "simt", "base"):
        if name not in libs:
            continue
        before = dict(k1.FRONTIER_ROUTES)
        with on(name):
            rep = repro_torch.solve(problem, method="frontier:pallas",
                                    device="cuda")
        routes = {k: v - before[k] for k, v in k1.FRONTIER_ROUTES.items()}
        solves[name].append({"wall_s": rep.wall_time_s,
                             "rounds": rep.n_rounds, "ops": rep.n_ops,
                             "routes": routes})
        print(f"cold frontier:pallas on {name}: converged {rep.converged} "
              f"rounds {rep.n_rounds} ops {rep.n_ops} wall "
              f"{rep.wall_time_s:.3f} s; K1 by body {json.dumps(routes)} on "
              f"{smi}", flush=True)
    result["cold_solves"] = solves
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
