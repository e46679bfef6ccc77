#!/usr/bin/env python3
"""The MoE dispatch's backward on one NVIDIA card: its kernel against the
plain version and the K5 route it replaced, in variants, timed in turns.

    python3 tools/dispatch_bwd_probe.py [VARIANT ...] [--against FILE ...]
                                        [--check-only] [--iters N]
                                        [--rounds N] [--seed S]

Prints the card's name and power limit first.  Builds
``src/repro_torch/csrc/dispatch_bwd.cu`` as it is ("base"), once per named
variant below (a list of source edits, each of which must find its text
once) and once per ``--against`` file (another ``dispatch_bwd.cu`` with
the entry ``moe_dispatch_bwd`` of the same arguments), all nvcc runs in
parallel, and prints ptxas's registers and spills for each build's
kernels.

The operands are ``chip_smoke.py`` phase 17 (d)'s: the dispatch's inputs
at layer 0 of a granite-moe-1b-a400m training microbatch (4 x 4,096
tokens, full width, bf16, random weights from ``--seed``, captured at
the first ``moe_dispatch`` of ``train_loss``; 131,072 slots of 16,384
tokens, top 8, into 163,840 buffer rows of 1,024), g from a seeded
generator.  The smoke captures them after 4 AdamW steps and the probe at
the initial weights, so the kept-slot count differs a little; both print
it, with the rows each route reads.

Each build is held to the plain version (relative L1 1e-5, and its bits),
to K5's route plus the cast (K5's bf16-row form over rows ``where(keep,
dest, 0)``, weight 1 a kept slot and 0 a dropped one, then ``.to(bf16)``:
its bits on finite g) and to a relaunch's bits; an ablation computes
something else, and its numbers are printed, not checked.  Unless
``--check-only``, every build, K5's route plus the cast, K5's launch
alone (float32 out), the cast alone and the library yardstick
(``index_add_`` of the kept rows into float32 sums) are timed with CUDA
events, a mean of ``--iters`` calls, in ``--rounds`` rounds, every other
one in reverse order, eagerly and (the builds and the route) replayed
from a CUDA graph of ``--iters`` calls, beside the byte bound (each kept
row, dest and keep read once, the bf16 output written once, over 3.35
TB/s).

Variants, each keeping the output's bits: ``batch1`` / ``batch2`` /
``batch8`` (kept rows a lane has in flight before its first add, not 4),
``ldg`` (the rows read through the read-only path, no evict-first hint),
``noalloc`` (``ld.global.nc.L1::no_allocate``), ``st_plain`` (the output
by plain stores, not streaming ones), ``cta256`` / ``cta512`` (threads a
CTA, not 128).  Ablations: ``no_gather`` (no row of g is read: the sums
run on zeros; what the indices and the stores cost), ``no_store`` (the
sums are written only where they are NaN, never here: what the reads
cost).  With no argument, none.  Exits non-zero without a card or when a
check fails.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUT = ROOT / "build" / "dispatch_bwd_probe"
_LOAD = "return __ldcs(reinterpret_cast<const uint4*>(p));"
_STORE = ("if (live) __stcs(reinterpret_cast<uint4*>(gx + t * d + c), "
          "V::pack(acc));")
VARIANTS = {
    "batch1": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "batch2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    "batch8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "ldg": [(_LOAD, "return __ldg(reinterpret_cast<const uint4*>(p));")],
    "noalloc": [(_LOAD, """uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;""")],
    "st_plain": [(_STORE, "if (live) *reinterpret_cast<uint4*>(gx + t * d + c) "
                          "= V::pack(acc);")],
    "cta256": [("constexpr int kThreads = 128;",
                "constexpr int kThreads = 256;")],
    "cta512": [("constexpr int kThreads = 128;",
                "constexpr int kThreads = 512;")],
    "no_gather": [(_LOAD, "return make_uint4(0u, 0u, 0u, 0u);")],
    "no_store": [(_STORE, "if (live && acc[0] != acc[0]) "
                          "__stcs(reinterpret_cast<uint4*>(gx + t * d + c), "
                          "V::pack(acc));")],
}
ABLATIONS = {"no_gather", "no_store"}
ARCH = "granite-moe-1b-a400m"
BATCH, SEQ = 4, 4096  # a microbatch of phase 17's train_4k cut
HBM_BYTES_PER_S = 3.35e12


def edited_source(name, edits):
    """csrc/dispatch_bwd.cu with ``edits`` made; each must find its text
    once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "dispatch_bwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"dispatch_bwd_probe: {name}: {old!r} is in "
                             f"dispatch_bwd.cu {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(name, source):
    """nvcc of ``source`` into build/dispatch_bwd_probe/<name>/lib.so;
    returns its path and ptxas's lines on its kernels."""
    from repro_torch.kernels import _build

    d = OUT / re.sub(r"\W", "_", name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(source)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(d / "lib.so"), str(d / "k.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{out.stdout}{out.stderr}")
    lines, kernel = [], ""
    for ln in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kernel = m.group(1)
        elif kernel and ("Used" in ln or "spill" in ln):
            short = re.search(r"dispatch_bwd_\w*?kernel(I\w*?E)?", kernel)
            lines.append(f"{name}: {short.group(0) if short else kernel}: "
                         f"{ln.split(':', 1)[-1].strip()}")
    return d / "lib.so", lines


def operands(torch, dev, seed):
    """Phase 17 (d)'s operands at the model's initial weights: ``(g, dest,
    keep, n)``."""
    from chip_smoke import _capture_first

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_token_batch
    from repro_torch.models import transformer

    cfg = get_arch(ARCH).model_cfg
    model = transformer.init_params(cfg, seed=seed, device=dev)
    batch = lm_token_batch(0, BATCH, SEQ, cfg.vocab, seed=seed)
    ins = _capture_first(torch, transformer, "moe_dispatch",
                         lambda: transformer.train_loss(model, batch))
    x, src = ins["args"][0], ins["args"][1]
    dest, keep = ins["kw"]["dest"], ins["kw"]["keep"]
    n, d, dtype = x.shape[0], x.shape[1], x.dtype
    del model, ins, x
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((src.numel(), d), generator=gen, device=dev).to(dtype)
    return g, dest, keep, n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--against", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        print(f"dispatch_bwd_probe: unknown variants {sorted(unknown)}; "
              f"known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("dispatch_bwd_probe: no card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    from chip_smoke import Timer

    from repro_torch.kernels import _build
    from repro_torch.kernels.segment import segment_sum_kernel
    from repro_torch.kernels.segment.dispatch_bwd import (
        _lib, dispatch_bwd_kernel, dispatch_bwd_ref)

    sources = {"base": edited_source("base", []),
               **{n: edited_source(n, VARIANTS[n]) for n in args.variants},
               **{f"against:{p}": p.read_text() for p in args.against}}
    with cf.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda kv: build(*kv),
                                           sources.items())))
    for _, lines in built.values():
        print("\n".join(lines), flush=True)
    own = _lib()
    libs = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(str(path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.moe_dispatch_bwd.argtypes = own.moe_dispatch_bwd.argtypes
        lib.moe_dispatch_bwd.restype = own.moe_dispatch_bwd.restype
        libs[name] = lib

    def through(lib):
        def run(*a):
            _build._LIBS["dispatch_bwd"] = lib
            try:
                return dispatch_bwd_kernel(*a)
            finally:
                _build._LIBS["dispatch_bwd"] = own
        return run

    dev = torch.device("cuda")
    g, dest, keep, n = operands(torch, dev, args.seed)
    ops = (g, dest, keep, n)
    m, d = dest.numel(), g.shape[1]
    kept = int(keep.sum())
    seg = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        m // n)
    rows, w = torch.where(keep, dest, 0), keep.float()
    n_read = int(torch.unique(dest[keep]).numel())
    size = g.element_size()
    n_bytes = n_read * d * size + m * 9 + n * d * size
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"operands: g {tuple(g.shape)} {str(g.dtype)[6:]}, {m} slots of "
          f"{n} tokens, {m - kept} dropped; rows read: {n_read} (the "
          f"kernel), {m} row copies of {int(torch.unique(rows).numel())} "
          f"rows (K5's route); bound {b_ms:.4f} ms ({n_bytes / 1e6:.1f} MB "
          "by bytes)", flush=True)

    def k5_route():
        return segment_sum_kernel(g, seg, n, w, rows).to(g.dtype)

    want = dispatch_bwd_ref(*ops)
    old = k5_route()
    ok = True
    for name, lib in libs.items():
        got = through(lib)(*ops)
        again = through(lib)(*ops)
        torch.cuda.synchronize()
        e = float((got.double() - want.double()).abs().sum()
                  / want.double().abs().sum())
        plain_bits, k5_bits = torch.equal(got, want), torch.equal(got, old)
        same = torch.equal(got, again)
        good = name in ABLATIONS or (e <= 1e-5 and plain_bits and k5_bits
                                     and same)
        ok &= good
        print(f"  {name}: relative L1 {e:.3e} (bound 1e-5), the plain "
              f"version's bits {plain_bits}, K5's route's bits {k5_bits}, "
              f"relaunch bit-identical {same}: "
              + ("an ablation, not checked" if name in ABLATIONS
                 else "ok" if good else "FAILED"), flush=True)
        del got, again
    del want, old
    if args.check_only or not ok:
        return 0 if ok else 1

    timer = Timer(torch, dev)
    k5_out = segment_sum_kernel(g, seg, n, w, rows)
    fns = {**{name: (lambda lib=lib: through(lib)(*ops))
              for name, lib in libs.items()},
           "K5 route + cast": k5_route,
           "K5 alone": lambda: segment_sum_kernel(g, seg, n, w, rows),
           "the cast alone": lambda: k5_out.to(g.dtype)}
    graphed = [*libs, "K5 route + cast"]
    eager = {k: [] for k in fns}
    graph = {k: [] for k in graphed}
    for r in range(args.rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            eager[k].append(timer(fns[k], args.iters))
            if k in graph:
                graph[k].append(timer.graphed(fns[k], args.iters))
    gw = g.index_select(0, dest[keep]).float()
    zeros = torch.zeros((n, d), dtype=torch.float32, device=dev)
    tok = seg.long()[keep]
    lib_ms = timer(lambda: zeros.index_add_(0, tok, gw), args.iters)
    for k, ms in eager.items():
        line = (f"{k}: eager {' / '.join(f'{t:.4f}' for t in ms)} ms a "
                f"call ({100 * b_ms / min(ms):.1f} % of the {b_ms:.4f} ms "
                "bound at the least)")
        if k in graph:
            line += (", graphed "
                     + " / ".join(f"{t:.4f}" for t in graph[k]) + " ms")
        print(line, flush=True)
    print(f"library (index_add_ of the kept rows, float32 out): "
          f"{lib_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
