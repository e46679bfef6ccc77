#!/usr/bin/env python3
"""Where K2 (the BSR product over a visit table) spends its time, on one
NVIDIA card.

    python3 tools/k2_probe.py [VARIANT ...] [--n N] [--json PATH]

Builds ``src/repro_torch/csrc/diffusion.cu`` once as it is ("base") and
once per named variant below, each a list of source edits (every edit
must find its text, or the tool stops), all nvcc runs in parallel; loads
each build in turn in place of the wrapper's library and times it
(CUDA events, ``chip_smoke.Timer``; the least of two rounds, the second
in reverse order, the greatest in brackets) at K2's two shapes of
``chip_smoke.py``:

- ``frontier``: ``bsr_spmm`` over the seed-0 ``host_block_graph(N)``
  tile pool at bs=128 (N = 2**21: 81,907 tiles of 64 KiB), C=1;
- ``engine``: ``bsr_gather_spmm``'s port, the ``engine:bsr`` session's
  visit table at k=4, ``slope_ema`` (512x512 tiles of 1 MiB), C=1;

beside ``torch.sparse.mm`` of a ``sparse_bsr`` matrix of the same tiles
and ``torch.sum`` over the whole tile pool (the card's streaming read
rate), with the bytes bound and the achieved TB/s, and the visits-per-row
histogram of each shape.  Every variant but ``bare`` must give the base
build's bits.

Variants (the base: two CTAs an SM, each with eight consumer warps and a
ring of 3 stages of 32 KiB slabs, no L2 policy on the tile copies):
``stages2`` (2 stages); ``slab16`` (16 KiB slabs), ``slab16_stages6``
(6 of them: the base's ring bytes); one CTA an SM with 3 (``cta1``), 4
(``cta1_stages4``) or 6 (``cta1_stages6``) stages of 32 KiB or 3 of 64
KiB (``cta1_slab64``), or with 16 consumer warps and 6 stages
(``cta1_warps16``); the stages are the launch's ``buffer_depth``
(``DEPTHS``), the rest source edits; ``evict_first`` (an evict_first L2 policy on the tile
copies);
``bare`` (the copies and the barrier protocol with no arithmetic: the
design's own floor); ``simt`` (the base build's other body, a CTA per
output row with 4-byte loads).  With no argument, all of them.  ``--json PATH`` writes every number there too.
Prints the card's name and power limit first; exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_SLAB = "constexpr int kSlabBytes = 32 * 1024;"
_CTA1 = ("constexpr int kCtasPerSm = 2;", "constexpr int kCtasPerSm = 1;")
_WARPS16 = ("constexpr int kBulkWarps = 8;", "constexpr int kBulkWarps = 16;")
_HINT = "constexpr bool kEvictFirst = false;"
_MATH = """        accumulate_slab(ring + (size_t)st * sr * bs, x_s, acc_s, row0, min(sr, bs - row0), bs, C,
                        warp, lane);
"""


def _slab(kib):
    return (_SLAB, f"constexpr int kSlabBytes = {kib} * 1024;")


# name: (source edits, route)
VARIANTS = {
    "stages2": ([], "bulk"),
    "slab16": ([_slab(16)], "bulk"),
    "slab16_stages6": ([_slab(16)], "bulk"),
    "cta1": ([_CTA1], "bulk"),
    "cta1_stages4": ([_CTA1], "bulk"),
    "cta1_stages6": ([_CTA1], "bulk"),
    "cta1_slab64": ([_CTA1, _slab(64)], "bulk"),
    "cta1_warps16": ([_CTA1, _WARPS16], "bulk"),
    "evict_first": ([(_HINT, "constexpr bool kEvictFirst = true;")], "bulk"),
    "bare": ([(_MATH, "")], "bulk"),
    "simt": ([], "simt"),
}
# the ring's stages are a launch parameter (buffer_depth d >= 2: d stages;
# the base runs depth 1, 3 stages)
DEPTHS = {"stages2": 2, "slab16_stages6": 6, "cta1_stages4": 4,
          "cta1_stages6": 6, "cta1_warps16": 6}
# a variant's slab size, which the wrapper's shared-memory rule
# (kernels/tune/model.py) must know to give its launch the bytes it takes
SLABS = {"slab16": 16, "slab16_stages6": 16, "cta1_slab64": 64}
OUT = ROOT / "build" / "k2_probe"


def edited_source(name, edits):
    """diffusion.cu with a variant's edits; stops if one misses its text."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "diffusion.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k2_probe: {name}: no {old!r} in diffusion.cu")
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


def least(timer, fns, iters):
    """{name: (least, greatest)} ms over two rounds, the second reversed."""
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(timer(fns[k], iters))
    return {k: (min(v), max(v)) for k, v in got.items()}


def histogram(row_ptr):
    """{visits: rows} of a row pointer."""
    import torch

    counts = torch.bincount(torch.diff(row_ptr).cpu())
    return {int(v): int(n) for v, n in enumerate(counts.tolist()) if n}


def main() -> int:
    import torch

    from chip_smoke import (
        BS, ENGINE_OPTS, HBM_BYTES_PER_S, Timer, nvidia_smi)
    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels.diffusion import kernel as k2
    from repro_torch.kernels.tune import model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of them")
    ap.add_argument("--n", type=int, default=2**21,
                    help="nodes of the host_block_graph (default 2**21)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    wanted = args.variants or list(VARIANTS)
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        print(f"k2_probe: no variant {sorted(unknown)}; there are "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    variants = {"base": ([], "bulk"), **{n: VARIANTS[n] for n in wanted}}
    sources = {n: tuple(e) for n, (e, _) in variants.items()}
    distinct = {}
    for name, edits in sources.items():  # simt runs the base build
        distinct.setdefault(edits, name)
    with cf.ThreadPoolExecutor(len(distinct)) as ex:
        built = list(ex.map(lambda n: build(n, list(sources[n])),
                            distinct.values()))
    for name, rc, errors in built:
        print(f"{name}: nvcc exit {rc}" + "".join(f"\n  {e}" for e in errors))
    if any(rc for _, rc, _ in built):
        return 1

    own_lib = k2._lib
    slab_bytes = model.SLAB_BYTES
    real = own_lib()
    libs = {}
    for name, edits in sources.items():
        lib = ctypes.CDLL(str(OUT / distinct[edits] / "lib.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fname in ("bsr_spmm", "bulk_ctas_per_sm"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    g = host_block_graph(args.n, seed=0)
    problem = repro_torch.Problem.pagerank(g)
    m = problem.graph.bsr(BS).to_device(dev)
    s_bsr = repro_torch.SolverSession(problem, "engine:bsr", device="cuda",
                                      **ENGINE_OPTS)
    eng, visits = s_bsr._driver.engine, s_bsr._driver.ex.table
    r_e, s_e = eng.a.n_rows, eng.a.bucket_size
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    shapes = {
        "frontier": (m.blocks, m.visit_block, m.block_col, m.row_ptr,
                     torch.rand((m.n_row_blocks, BS, 1), generator=gen,
                                device=dev)),
        "engine": (eng.pool, visits.visit_block, visits.visit_col,
                   visits.row_ptr,
                   torch.rand((r_e, s_e, 1), generator=gen, device=dev)),
    }
    result = {"device": smi, "n": args.n, "shapes": {}}
    for sname, ins in shapes.items():
        blocks, vb, vc, ptr, x = ins
        nrb, bs, v = ptr.numel() - 1, x.shape[1], vb.numel()
        n_bytes = (v * bs * bs * 4 + v * 8 + ptr.numel() * 8
                   + x.numel() * 4 + nrb * bs * 4)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        hist = histogram(ptr)
        print(f"== {sname}: {nrb} output rows of bs={bs}, {v} visits "
              f"({v * bs * bs * 4 / 1e9:.3f} GB of tiles); visits per row "
              f"{hist}")

        def run(name, ins=ins):
            k2._lib = lambda: libs[name]
            model.SLAB_BYTES = SLABS.get(name, 32) * 1024
            try:
                return k2.launch_bsr_spmm(
                    *ins, route=variants[name][1],
                    buffer_depth=DEPTHS.get(name, 1))[0]
            finally:
                k2._lib = own_lib
                model.SLAB_BYTES = slab_bytes

        base = run("base")
        for name in variants:
            got = run(name)
            same = torch.equal(got, base)
            print(f"{sname} {name}: bit-identical to base {same}")
            if name != "bare" and not same:
                raise SystemExit(f"k2_probe: {sname} {name} changes bits")
            del got
        fns = {name: (lambda name=name: run(name)) for name in variants}
        a_bsr = torch.sparse_bsr_tensor(ptr, vc.long(), blocks[vb.long()],
                                        size=(nrb * bs, x.shape[0] * bs))
        x2 = x.reshape(-1, 1)
        fns["library"] = lambda: torch.sparse.mm(a_bsr, x2)
        fns["read"] = lambda: blocks.sum()
        lib_err = float((torch.sparse.mm(a_bsr, x2).reshape(base.shape)
                         - base).abs().max())
        del base
        times = least(timer, fns, 10)
        del fns, a_bsr
        lib_ms, read_ms = times["library"][0], times["read"][0]
        pool_bytes = blocks.numel() * 4
        result["shapes"][sname] = {
            "bytes": n_bytes, "bound_ms": b_ms, "visits_per_row": hist,
            "times": times, "library_max_abs_diff": lib_err}
        print(f"== {sname}: bound {b_ms:.4f} ms ({n_bytes / 1e9:.3f} GB); "
              f"library {lib_ms:.4f} ms [{times['library'][1]:.4f}] "
              f"({n_bytes / lib_ms / 1e9:.3f} TB/s, max abs diff "
              f"{lib_err:.3e}); torch.sum over the {pool_bytes / 1e9:.3f} GB"
              f" pool {read_ms:.4f} ms [{times['read'][1]:.4f}] "
              f"({pool_bytes / read_ms / 1e9:.3f} TB/s) on {smi}")
        for name in variants:
            t, worst = times[name]
            print(f"  {name}: {t:.4f} ms [{worst:.4f}] {n_bytes / t / 1e9:.3f}"
                  f" TB/s  x{t / b_ms:.3f} bound, x{t / lib_ms:.3f} library",
                  flush=True)
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
