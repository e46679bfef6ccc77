#!/usr/bin/env python3
"""K6's backward on one NVIDIA card: the wgmma pair against its plain
version, in variants, beside the mma.sync pair it replaced and the
library's backward; the training forward beside serving's.

    python3 tools/k6_bwd_probe.py [VARIANT ...] [--against FILE ...]
                                  [--forward-against FILE]
                                  [--check-only] [--iters N]

Prints the card's name and power limit.  Builds
``src/repro_torch/csrc/attention_bwd.cu`` as it is ("base"), once per named
variant below (a list of source edits, each of which must find its text
once) and once per ``--against`` file (another ``attention_bwd.cu`` with
the same C interface, e.g. ``git show
HEAD~1:src/repro_torch/csrc/attention_bwd.cu > build/parent_bwd.cu``), all
nvcc runs in parallel, and ``csrc/attention.cu`` as it is; prints what
ptxas says of every wgmma kernel (registers, spills, serialised wgmma).
Then, each build loaded in turn in place of the package's library:

- at small bf16 shapes (Dh 64 and 128, GQA, causal and bidirectional,
  ragged Sq and Sk) and at 1 x 16 x 4,096, Dh 64, causal, the training
  forward (``flash_attention_lse``) against serving's forward (o
  bit-equal) and the plain log2-sum-exp (within 1e-5, absolute and
  relative), and each build's wgmma pair against ``attention_bwd_plain``:
  relative L1 of dq, dk and dv (bound 1e-2) and a relaunch
  bit-identical, checked for base, the reorganising variants and
  ``--against`` (an ablation computes garbage: its numbers are printed),
  and whether its bits are base's;
- unless ``--check-only``, times (CUDA events, eager, a mean of
  ``--iters`` calls; two rounds, the second in reverse order) at phase 17
  (b)'s operands, 4 x 16 heads x 4,096 tokens, Dh 64, bf16, causal: every
  build's wgmma pair, the mma.sync pair (the library's private entry),
  the backward of ``scaled_dot_product_attention``, and the training
  forward beside serving's, with TFLOP/s of the five counted products
  (the forward's two); then each pair's two kernels apart under
  torch.profiler.

``--forward-against FILE`` builds another ``attention.cu`` with the same
C interface (``git show HEAD~1:src/repro_torch/csrc/attention.cu >
build/parent_attention.cu``) beside the package's, prints ptxas's lines
on its wgmma kernels too, and holds serving's prefill (``flash_attention``,
bf16, causal) of both builds to each other's bits and times them in
turns (this, that, that, this) at phase 12's layers A (8 x 2,048) and B
(1 x 32,768) and at phase 17 (b)'s: serving's forward before and after
a change to ``attention.cu``.

Variants: ``no_exp2`` (the ex2 of P replaced by a copy: no MUFU work),
``no_cvt`` (P and dS cut to bf16 by a byte permute, not rounded by the
conversion instruction), ``dq2`` (the dQ kernel at Dh 64 on two consumer
warpgroups, 128-row blocks, not three), ``group1`` / ``group4`` (CTAs in
groups of 1 or 4 blocks, not 8, each group's blocks of a head side by
side: see ``block_order``), ``deep`` (at Dh 64, 8 dK / dV stages, not 4, and 5 dQ
stages, not 3), ``phases`` (the source's phase
hooks, ``BWD_START`` / ``BWD_STAMP``, defined to add each consumer
warpgroup's ``clock64`` between stamps to a counter a phase; after the
timing the probe prints each phase's clocks a visit and share, from
``--iters`` calls).  With no argument, none.  Exits non-zero without a
card or when a check fails.
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
sys.path[:0] = [str(ROOT / "src")]

OUT = ROOT / "build" / "k6_bwd_probe"
PHASE_HOOKS = """__device__ unsigned long long bwd_phase_clk[16], bwd_phase_n[16];
#define BWD_START() long long bwd_t0 = clock64()
#define BWD_STAMP(i)                                                        \\
  do {                                                                      \\
    if ((threadIdx.x & 127) == 0) {                                         \\
      const long long t_ = clock64();                                       \\
      atomicAdd(&bwd_phase_clk[i], (unsigned long long)(t_ - bwd_t0));     \\
      atomicAdd(&bwd_phase_n[i], 1ull);                                     \\
      bwd_t0 = t_;                                                          \\
    }                                                                       \\
  } while (0)
"""
PHASE_READER = """int bwd_phases(unsigned long long* clk, unsigned long long* n) {
  static const unsigned long long zero[16] = {};
  cudaError_t e = cudaMemcpyFromSymbol(clk, bwd_phase_clk, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, bwd_phase_n, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bwd_phase_clk, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bwd_phase_n, zero, sizeof(zero));
  return e;
}

"""
VARIANTS = {
    "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                 "y = x;")],
    "no_cvt": [("pk[i] = pack_bf16(x[2 * i], x[2 * i + 1]);",
                "pk[i] = __byte_perm(__float_as_uint(x[2 * i]), "
                "__float_as_uint(x[2 * i + 1]), 0x7632);")],
    "dq2": [("template <int DH>\nconstexpr int kDqConsumers = DH == 64 ? 3 : 2;",
             "template <int DH>\nconstexpr int kDqConsumers = 2;")],
    "group1": [("constexpr int kGroupBlocks = 8;",
                "constexpr int kGroupBlocks = 1;")],
    "group4": [("constexpr int kGroupBlocks = 8;",
                "constexpr int kGroupBlocks = 4;")],
    "deep": [("static constexpr int kStagesKV = DH == 64 ? 4 : 3;",
              "static constexpr int kStagesKV = DH == 64 ? 8 : 3;"),
             ("static constexpr int kStagesQ = DH == 64 ? 3 : 2;",
              "static constexpr int kStagesQ = DH == 64 ? 5 : 2;")],
    "phases": [("#define BWD_START()\n#define BWD_STAMP(i)\n", PHASE_HOOKS),
               ("}  // extern \"C\"\n", PHASE_READER + '}  // extern "C"\n')],
}
# the clocks between stamps, as the `phases` variant names them
PHASES = {0: "dK/dV wait for the stage", 1: "dK/dV issue S^T, dP^T",
          2: "dK/dV wait S^T", 3: "dK/dV P^T (ex2) and pack",
          4: "dK/dV issue dV, wait dP^T", 5: "dK/dV dS^T, pack, issue dK",
          6: "dK/dV wait dV, dK; release",
          8: "dQ wait for the stage", 9: "dQ issue S, dP (a half)",
          10: "dQ wait S", 11: "dQ P (ex2)", 12: "dQ wait dP",
          13: "dQ dS, pack, issue dQ", 14: "dQ wait dQ; release"}
ABLATIONS = ("no_exp2", "no_cvt", "phases")  # they compute garbage on purpose
# (batch, q heads, kv heads, Sq, Sk, Dh, causal)
CHECKS = [(2, 4, 2, 200, 200, 64, True), (2, 4, 4, 65, 65, 64, False),
          (1, 8, 2, 1000, 1000, 128, True), (2, 4, 2, 300, 300, 128, False),
          (1, 4, 2, 300, 200, 64, False), (1, 16, 16, 4096, 4096, 64, True)]
SHAPE = (4, 16, 16, 4096, 64)  # phase 17 (b): a microbatch's layer 0


def edited_source(name, edits):
    """csrc/attention_bwd.cu with ``edits`` made; each must find its text
    once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "attention_bwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"k6_bwd_probe: {name}: {old!r} is in "
                             f"attention_bwd.cu {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(name, source):
    """nvcc of ``source`` into build/k6_bwd_probe/<name>/lib.so; returns
    its path and ptxas's lines on its wgmma kernels."""
    from repro_torch.kernels import _build

    d = OUT / name.replace(":", "_")
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
            continue
        if "C7520" in ln or "serializ" in ln or (
                "wgmma" in kernel and ("Used" in ln or "spill" in ln)):
            short = re.search(r"(bwd_\w+?_kernel|flash_\w+?_kernel)"
                              r"(I\w*?E)?E", kernel)
            lines.append(f"{name}: {short.group(0) if short else kernel}: "
                         f"{ln.strip()}")
    return d / "lib.so", lines


def rel_l1(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--against", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--forward-against", type=pathlib.Path, default=None)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        print(f"k6_bwd_probe: unknown variants {sorted(unknown)}; known: "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("k6_bwd_probe: no card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    from repro_torch.kernels import _build

    sources = {"base": edited_source("base", []),
               "attention.cu": (_build.CSRC / "attention.cu").read_text(),
               **{n: edited_source(n, VARIANTS[n]) for n in args.variants},
               **{f"against:{p.name}": p.read_text() for p in args.against}}
    if args.forward_against is not None:
        sources["forward-against"] = args.forward_against.read_text()
    with cf.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda kv: build(*kv),
                                           sources.items())))
    for _, lines in built.values():
        print("\n".join(lines), flush=True)
    libs = {}
    for name, (path, _) in built.items():
        if name in ("attention.cu", "forward-against"):
            continue
        lib = ctypes.CDLL(str(path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    import torch.nn.functional as fn

    from repro_torch.kernels.attention import (attention_bwd_plain,
                                               attention_plain,
                                               flash_attention,
                                               flash_attention_bwd)
    from repro_torch.kernels.attention.backward import (
        BWD_ROUTES, _flash_attention_bwd_mma_sync)
    from repro_torch.kernels.attention.kernel import flash_attention_lse

    def bwd_of(lib):
        """flash_attention_bwd through ``lib`` in place of the package's
        library."""
        def run(*a, **kw):
            own = _build.library("attention_bwd")
            _build._LIBS["attention_bwd"] = lib
            try:
                return flash_attention_bwd(*a, **kw)
            finally:
                _build._LIBS["attention_bwd"] = own
        return run

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def bshd(b, s, h, dh, scale):
        return (torch.randn((b, s, h, dh), generator=gen, device=dev)
                * scale).to(torch.bfloat16).transpose(1, 2)

    ok = True
    for b, hq, hkv, sq, sk, dh, causal in CHECKS:
        q, k, v = bshd(b, sq, hq, dh, 0.5), bshd(b, sk, hkv, dh, 0.5), bshd(
            b, sk, hkv, dh, 1.0)
        do = bshd(b, sq, hq, dh, 1.0)
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        served = flash_attention(q, k, v, causal=causal)
        f32 = [t.float() for t in (q, k, v, o, do)]
        parts = [attention_bwd_plain(*(t[i:i + 1] for t in f32),
                                     causal=causal) for i in range(b)]
        want = [torch.cat(p) for p in zip(*parts)]
        _, l_plain = attention_plain(*f32[:3], causal=causal, lse=True)
        l_err = float(((lse[..., :sq] - l_plain).abs()
                       / (1 + l_plain.abs())).max())
        o_same = torch.equal(o, served)
        ok &= o_same and l_err <= 1e-5
        print(f"B {b} Hq {hq} Hkv {hkv} Sq {sq} Sk {sk} Dh {dh} causal "
              f"{causal}: the training forward's o bit-equal to serving's "
              f"{o_same}, L max |dL|/(1+|L|) {l_err:.3e} (bound 1e-5)",
              flush=True)
        base = None
        for name, lib in libs.items():
            before = BWD_ROUTES["wgmma"]
            got = bwd_of(lib)(q, k, v, o, do, causal=causal, lse=lse)
            again = bwd_of(lib)(q, k, v, o, do, causal=causal, lse=lse)
            torch.cuda.synchronize()
            base = got if base is None else base
            routed = BWD_ROUTES["wgmma"] - before
            errs = [rel_l1(g.float(), w) for g, w in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            bits = all(torch.equal(x, y) for x, y in zip(got, base))
            good = name in ABLATIONS or (
                same and routed == 2 and max(errs) <= 1e-2
                and all(bool(torch.isfinite(g).all()) for g in got))
            ok &= good
            print(f"  {name}: relative L1 dq {errs[0]:.3e} dk {errs[1]:.3e} "
                  f"dv {errs[2]:.3e} (bound 1e-2), relaunch bit-identical "
                  f"{same}, base's bits {bits}, wgmma launches {routed}: "
                  + ("an ablation, not checked" if name in ABLATIONS
                     else "ok" if good else "FAILED"), flush=True)
            del got, again
        del q, k, v, do, o, lse, want, f32, parts, base
    if args.forward_against is not None:  # serving's prefill, before / after
        other = ctypes.CDLL(str(built["forward-against"][0]))
        other.cuda_error_string.argtypes = [ctypes.c_int]
        other.cuda_error_string.restype = ctypes.c_char_p
        own = _build.library("attention")
        # the entry serving calls, typed as the package types its own (an
        # older build may lack the others, which serving does not call)
        other.flash_attention.argtypes = own.flash_attention.argtypes
        other.flash_attention.restype = own.flash_attention.restype

        def served_by(lib, q, k, v):
            _build._LIBS["attention"] = lib
            try:
                return flash_attention(q, k, v, causal=True)
            finally:
                _build._LIBS["attention"] = own

        for tag, (b, h, s) in {"A": (8, 16, 2048), "B": (1, 16, 32768),
                               "17 (b)": (4, 16, 4096)}.items():
            q, k, v = (bshd(b, s, h, 64, 1.0) for _ in range(3))
            same = torch.equal(served_by(own, q, k, v),
                               served_by(other, q, k, v))
            ok &= same
            ms = {"this": [], "that": []}
            for name in ("this", "that", "that", "this"):
                lib = own if name == "this" else other
                for _ in range(2):
                    served_by(lib, q, k, v)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    served_by(lib, q, k, v)
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / args.iters)
            print(f"serving's prefill at {tag} ({b} x {h} x {s}, Dh 64, "
                  f"causal): this build {' / '.join(f'{x:.4f}' for x in ms['this'])}"
                  f" ms, {args.forward_against.name} "
                  f"{' / '.join(f'{x:.4f}' for x in ms['that'])} ms, "
                  f"bit-equal {same}", flush=True)
            del q, k, v
    if args.check_only or not ok:
        return 0 if ok else 1

    b, h, _, s, dh = SHAPE
    q, k, v = bshd(b, s, h, dh, 1.0), bshd(b, s, h, dh, 1.0), bshd(
        b, s, h, dh, 1.0)
    do = bshd(b, s, h, dh, 0.01)
    o, lse = flash_attention_lse(q, k, v, causal=True)
    pairs = b * h * s * (s + 1) // 2
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn_, n=args.iters):
        for _ in range(2):
            fn_()
        start.record()
        for _ in range(n):
            fn_()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = fn.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    fns = {
        "mma.sync pair": lambda: _flash_attention_bwd_mma_sync(
            q, k, v, o, do, causal=True),
        **{f"{name} wgmma pair": (lambda lib=lib: bwd_of(lib)(
            q, k, v, o, do, causal=True, lse=lse)) for name, lib in
           libs.items()},
        "library backward": lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do, retain_graph=True),
        "serving forward": lambda: flash_attention(q, k, v, causal=True),
        "training forward": lambda: flash_attention_lse(q, k, v,
                                                        causal=True),
    }
    got = {n: [] for n in fns}
    order = list(fns)
    for turn in (order, order[::-1]):
        for n in turn:
            got[n].append(timed(fns[n]))
    for n, ms in got.items():
        prods = 2 if "forward" in n else 5
        print(f"{n}: {' / '.join(f'{t:.4f}' for t in ms)} ms a call at "
              f"{b} x {h} x {s}, Dh {dh}, causal ({prods} products: "
              f"{prods * 2 * dh * pairs / min(ms) / 1e9:.1f} TFLOP/s at the "
              "least)", flush=True)
    if "phases" in libs:  # each consumer phase's clocks a visit
        lib = libs["phases"]
        clk, cnt = (ctypes.c_uint64 * 16)(), (ctypes.c_uint64 * 16)()
        lib.bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.bwd_phases(clk, cnt)  # zeroes them
        for _ in range(args.iters):
            fns["phases wgmma pair"]()
        torch.cuda.synchronize()
        lib.bwd_phases(clk, cnt)
        for first in (0, 8):
            total = sum(clk[i] for i in PHASES if first <= i < first + 8)
            print("phases: " + "; ".join(
                f"{PHASES[i]} {clk[i] / max(cnt[i], 1):.0f} clk a visit "
                f"({100 * clk[i] / max(total, 1):.1f} %)"
                for i in PHASES if first <= i < first + 8), flush=True)
    # each pair's kernels apart, by torch.profiler's device times
    from torch.profiler import ProfilerActivity, profile

    for n in [n for n in fns if n.endswith("pair")]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fns[n]()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0))
                for e in prof.key_averages() if e.count]
        print(f"{n} under torch.profiler, {args.iters} calls: " + "; ".join(
            f"{key[:40]} x{cnt} {us / cnt / 1e3:.4f} ms" for key, cnt, us
            in sorted(rows, key=lambda r: -r[2]) if us > 0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
