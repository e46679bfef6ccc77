#!/usr/bin/env python3
"""The FM tables' gradient (``csrc/embedding_bwd.cu``) on one NVIDIA card
at the ``train_batch`` cell, against K5's gather form that it replaced and
the library, over tile sizes, grids and source variants.

    python3 tools/emb_bwd_probe.py [VARIANT ...] [--rows R ...]
                                   [--lin-rows R ...] [--ctas C ...]
                                   [--iters N] [--seed S] [--check-only]

Prints the card's name and power limit first.  Builds
``src/repro_torch/csrc/embedding_bwd.cu`` as it is ("base") and once per
named variant below (a list of source edits, each of which must find its
text once), all nvcc runs in parallel, and prints ptxas's registers,
spills and shared memory for each build's kernels.

The operands are ``chip_smoke.py`` phase 9 (b)'s: the ``fm`` config's
fused table of 39 fields x 10**6 rows, the rows of
``criteo_like_batch(10, 65536, 39, 10**6, seed)`` (2,555,904 ids), their
stable sort (the sorted ids int32, the order int64), a seeded normal g of
``[2,555,904, 10]`` for the table (bag 1) and of ``[65,536, 1]`` for the
linear table (bag 39).

Each build is held at both widths to the plain version (relative L1 <=
1e-5), to a relaunch (bit-identical) and, unless it sums in another order,
to base's bits.  Unless ``--check-only``, every build at every tile size
(``--rows`` at D = 10, ``--lin-rows`` at D = 1; 0 is the source's own) and
CTAs an SM (``--ctas``, at most as many as fit; 0 the source's own) is
timed with CUDA events, a mean of ``--iters`` calls, in
two rounds, the second in reverse order, on four sets of ids: the whole
batch's, none (the output's zeros alone), the batch's without the first
1,024 rows of each field (where the zipf ids put 82 % of them), those
rows' alone, and field 0's alone (one tile's ids: how long a tile of
~51,000 ids takes).  Beside them: K5's gather form over the same rows (its
sources ``order // bag`` made outside the timed region),
``zeros().index_add_`` of the same rows, a ``torch.zeros`` of the output
alone and the byte bound (each input byte read once, the output written
once, over 3.35 TB/s).

Variants: ``threads128`` / ``threads512`` (threads a CTA, not 256),
``items_more`` / ``items_less`` (twice / half the entries a lane loads at
once; ``items1``: one), ``minb1`` / ``minb4`` (registers for 1 / 4 CTAs
an SM, not 2), ``bounds_free`` (no register bound),
``no_fast`` (no lane-private sums for 32 entries that continue the open
run: every group scanned), ``st_plain`` (the tile
leaves by plain 16-byte stores, not streaming ones), ``ldg_rows`` /
``ldg_ids`` (B reads g's rows / the ids with the default cache policy, not
evict-first).  ``clocks`` (each
CTA stamps %globaltimer at the start, after A's and B's barriers and at its
end: the phases' µs at train_batch are printed).  Ablations, timed and not
checked: ``no_gather`` (no row of g read), ``no_place`` (C loads its
runs and places none), ``no_runs`` (C neither loads nor places a run).  Exits non-zero
without a card or when a check fails.
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

OUT = ROOT / "build" / "emb_bwd_probe"
# the `clocks` variant's hook: each CTA's thread 0 stamps %globaltimer at
# the kernel's start, after A's and B's grid barriers and at its end
CLOCKS = """__device__ unsigned long long emb_stamps[4][4096];
#define EMB_STAMP(i) do { if (threadIdx.x == 0 && blockIdx.x < 4096) { \\
    unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
    emb_stamps[i][blockIdx.x] = t_; } } while (0)
extern "C" int embedding_bwd_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, emb_stamps, sizeof(emb_stamps));
}
"""
VARIANTS = {
    "threads128": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;"),
                   ("constexpr int kMinCtas = 2;", "constexpr int kMinCtas = 4;")],
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;"),
                   ("constexpr int kMinCtas = 2;", "constexpr int kMinCtas = 1;")],
    "items_more": [("return maxd >= 8 ? 1 : maxd >= 2 ? 2 : 4;",
                    "return maxd >= 8 ? 2 : maxd >= 2 ? 4 : 8;")],
    "items_less": [("return maxd >= 8 ? 1 : maxd >= 2 ? 2 : 4;",
                    "return maxd >= 2 ? 1 : 2;")],
    "items1": [("return maxd >= 8 ? 1 : maxd >= 2 ? 2 : 4;", "return 1;")],
    "bounds_free": [("__launch_bounds__(kThreads, kMinCtas)", "__launch_bounds__(kThreads)")],
    "minb1": [("constexpr int kMinCtas = 2;", "constexpr int kMinCtas = 1;")],
    "minb4": [("constexpr int kMinCtas = 2;", "constexpr int kMinCtas = 4;")],
    "no_fast": [("if (starts == 0) {", "if (starts == 0 && false) {")],
    "no_gather": [("  if (src < 0) return;", "  if (src < 0 || true) return;")],
    "clocks": [("#define EMB_STAMP(i)\n", CLOCKS)],
    "ldg_rows": [("const float2 p = __ldcs(reinterpret_cast<const float2*>(r + j));",
                  "const float2 p = __ldg(reinterpret_cast<const float2*>(r + j));"),
                 ("if (j < dg) x[j] = __ldcs(r + j);", "if (j < dg) x[j] = __ldg(r + j);")],
    "ldg_ids": [("return bytes == 8 ? (uint64_t)__ldcs(", "return bytes == 8 ? (uint64_t)__ldg("),
                (": (uint64_t)__ldcs(static_cast<const unsigned*>(p) + e);",
                 ": (uint64_t)__ldg(static_cast<const unsigned*>(p) + e);")],
    "no_place": [("if (r0 + threadIdx.x < r1) place(", "if (r0 + threadIdx.x < r1 && cur.key == INT_MIN) place("),
                 ("for (int64_t r = r0 + kThreads + threadIdx.x; r < r1; r += kThreads) {",
                  "for (int64_t r = r1; r < r1; r += kThreads) {")],
    "no_runs": [("if (r0 + threadIdx.x < r1) place(", "if (false) place("),
                ("for (int64_t r = r0 + kThreads + threadIdx.x; r < r1; r += kThreads) {",
                 "for (int64_t r = r1; r < r1; r += kThreads) {"),
                ("if (tn < a.n_tiles && a.tile_start[tn]", "if (false && a.tile_start[tn]"),
                ("if (t < a.n_tiles && a.tile_start[t]", "if (false && a.tile_start[t]")],
    "st_plain": [("__stcs(reinterpret_cast<float4*>(dst) + i, t4[i]);",
                  "reinterpret_cast<float4*>(dst)[i] = t4[i];")],
}
# variants that sum in another order: held to the plain version, not to
# base's bits
# (the grid sets the warps' pieces: variants that change how many CTAs fit
# do too)
REORDERS = {"threads128", "threads512", "no_fast", "minb1", "minb4",
            "bounds_free", "clocks"}
# variants that compute something else: timed, not checked
ABLATIONS = {"no_gather", "no_place", "no_runs"}
N_FIELDS, VOCAB, BATCH, DIM = 39, 1_000_000, 65_536, 10


def edited_source(name, edits):
    """csrc/embedding_bwd.cu with ``edits`` made; each must find its text
    once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "embedding_bwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"emb_bwd_probe: {name}: {old!r} is in "
                             f"embedding_bwd.cu {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(name, source):
    """nvcc of ``source`` into build/emb_bwd_probe/<name>/lib.so; returns
    its path and ptxas's lines on its kernels."""
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
            short = re.search(r"embedding_bwd_kernelILi\d+E", kernel)
            lines.append(f"{name}: {short.group(0) if short else kernel}: "
                         f"{ln.split(':', 1)[-1].strip()}")
    return d / "lib.so", lines


def operands(torch, dev, seed):
    """train_batch's lookup: ``(rows, seg, order, g, g_lin)``."""
    import numpy as np

    from repro_torch.data import criteo_like_batch

    ids = criteo_like_batch(10, BATCH, N_FIELDS, VOCAB, seed=seed)["ids"]
    rows = torch.as_tensor((ids + np.arange(N_FIELDS, dtype=np.int32)
                            * VOCAB).reshape(-1), device=dev)
    seg, order = torch.sort(rows, stable=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((rows.numel(), DIM), generator=gen, device=dev)
    g_lin = torch.randn((BATCH, 1), generator=gen, device=dev)
    return rows, seg, order, g, g_lin


def clocks(torch, lib, through, widths, loads, n):
    """The `clocks` build's phases on each set of ids: A (count), B (sums)
    and C (tiles) in µs from the CTAs' %globaltimer stamps, C's CTAs at the
    median and the 90th percentile, and the slowest CTAs' indices."""
    import numpy as np

    lib.embedding_bwd_stamps.argtypes = [ctypes.c_void_p]
    lib.embedding_bwd_stamps.restype = ctypes.c_int
    for what, (gg, bag, _) in widths.items():
        for load, (sg, od) in loads.items():
            for _ in range(3):
                through(lib, gg, sg, od, n, bag)
            torch.cuda.synchronize()
            st = np.zeros((4, 4096), np.uint64)
            if lib.embedding_bwd_stamps(st.ctypes.data):
                raise SystemExit("emb_bwd_probe: reading the stamps failed")
            ctas = np.flatnonzero(st[0] > 0)
            st = st[:, ctas].astype(np.float64) / 1e3  # µs
            ends = st[3] - st[2].max()
            srt = np.sort(ends)
            print(f"clocks {what} {load} ({ctas.size} CTAs): A "
                  f"{st[1].max() - st[0].min():.1f} µs, B "
                  f"{st[2].max() - st[1].max():.1f} µs, C {srt[-1]:.1f} µs "
                  f"(CTAs done at the median {np.median(srt):.1f}, the 90th "
                  f"percentile {srt[int(0.9 * (srt.size - 1))]:.1f}; the "
                  f"slowest {ctas[np.argsort(ends)[-5:]].tolist()})",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--rows", type=int, nargs="*", default=[0])
    ap.add_argument("--lin-rows", type=int, nargs="*", default=[0])
    ap.add_argument("--ctas", type=int, nargs="*", default=[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        print(f"emb_bwd_probe: unknown variants {sorted(unknown)}; known: "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("emb_bwd_probe: no card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    from chip_smoke import Timer, bound_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment import segment_sum_kernel
    from repro_torch.kernels.segment.embedding_bwd import (
        _launch, _lib, embedding_bwd_ref)

    sources = {"base": edited_source("base", []),
               **{n: edited_source(n, VARIANTS[n]) for n in args.variants}}
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
        for entry in ("embedding_bwd", "embedding_bwd_tile_rows",
                      "embedding_bwd_scratch"):
            getattr(lib, entry).argtypes = getattr(own, entry).argtypes
            getattr(lib, entry).restype = getattr(own, entry).restype
        libs[name] = lib

    def through(lib, *a, **kw):
        _build._LIBS["embedding_bwd"] = lib
        try:
            return _launch(*a, **kw)
        finally:
            _build._LIBS["embedding_bwd"] = own

    dev = torch.device("cuda")
    rows, seg, order, g, g_lin = operands(torch, dev, args.seed)
    n = N_FIELDS * VOCAB
    e = seg.numel()
    hot = int(torch.bincount(seg.long()).max())
    print(f"operands: {e} ids into {n} rows, the hottest id in {hot} rows; "
          f"seg {str(seg.dtype)[6:]}, order {str(order.dtype)[6:]}; g "
          f"{tuple(g.shape)}, g_lin {tuple(g_lin.shape)} (bag {N_FIELDS})",
          flush=True)
    widths = {"table": (g, 1, args.rows), "lin": (g_lin, N_FIELDS,
                                                  args.lin_rows)}
    ok = True
    for what, (gg, bag, _) in widths.items():
        want = embedding_bwd_ref(gg, seg, order, n, bag)
        base = None
        for name, lib in libs.items():
            got = through(lib, gg, seg, order, n, bag)
            again = through(lib, gg, seg, order, n, bag)
            torch.cuda.synchronize()
            base = got if base is None else base
            err = float((got.double() - want.double()).abs().sum()
                        / want.double().abs().sum())
            same, bits = torch.equal(got, again), torch.equal(got, base)
            good = name in ABLATIONS or (
                err <= 1e-5 and same and (bits or name in REORDERS))
            ok &= good
            print(f"  {what} {name}: relative L1 {err:.3e} (bound 1e-5), "
                  f"relaunch bit-identical {same}, base's bits {bits}"
                  + (" (sums in another order)" if name in REORDERS else "")
                  + ": " + ("an ablation, not checked" if name in ABLATIONS
                            else "ok" if good else "FAILED"), flush=True)
            del got, again
        del want, base
    if args.check_only or not ok:
        return 0 if ok else 1
    # the ids outside (and inside) the first 1,024 rows of each field, where
    # the zipf ids put 82 % of them: the hot tiles' share of the time
    hot = (seg % VOCAB) < 1024
    one = seg < 1024
    loads = {"train_batch": (seg, order),
             "no ids": (seg[:0], order[:0]),
             "no hot tiles": (seg[~hot], order[~hot]),
             "hot tiles only": (seg[hot], order[hot]),
             "one hot tile": (seg[one], order[one])}
    if "clocks" in libs:
        clocks(torch, libs["clocks"], through, widths, loads, n)

    timer = Timer(torch, dev)
    rows_l = rows.long()
    print("ids a workload: " + ", ".join(f"{k} {v[0].numel()}"
                                         for k, v in loads.items()))
    for what, (gg, bag, sizes) in widths.items():
        d = gg.shape[1]
        bound = bound_ms(gg.numel() * 4 + e * 12 + n * d * 4, e * d)[0]
        src = order if bag == 1 else torch.div(order, bag,
                                               rounding_mode="floor")
        rep = gg.repeat_interleave(bag, 0) if bag > 1 else gg
        fns = {}
        for name, lib in libs.items():
            for r in sizes:
                for c in args.ctas:
                    label = f"{name} rows {r or 'own'} ctas {c or 'own'}"
                    for load, (sg, od) in loads.items():
                        fns[(label, load)] = (
                            lambda lib=lib, r=r, c=c, sg=sg, od=od: through(
                                lib, gg, sg, od, n, bag, rows_a_tile=r,
                                ctas_per_sm=c))
        fns[("K5 gather form", "train_batch")] = lambda: segment_sum_kernel(
            gg, seg, n, None, src)
        fns[("zeros().index_add_", "train_batch")] = lambda: torch.zeros(
            (n, d), device=dev).index_add_(0, rows_l, rep)
        fns[("torch.zeros", "no ids")] = lambda: torch.zeros((n, d),
                                                             device=dev)
        got = {k: [] for k in fns}
        for turn in (list(fns), list(fns)[::-1]):
            for k in turn:
                got[k].append(timer(fns[k], args.iters))
        print(f"{what} (D = {d}, bag {bag}; bound {bound:.4f} ms at "
              f"train_batch); least / greatest of two means of "
              f"{args.iters} calls, ms, by workload "
              f"({' | '.join(loads)}):", flush=True)
        for label in dict.fromkeys(k for k, _ in fns):
            cells = [got.get((label, load)) for load in loads]
            print(f"  {label}: " + " | ".join(
                "-" if c is None else f"{min(c):.4f} / {max(c):.4f}"
                for c in cells), flush=True)
        del rep, src
    return 0


if __name__ == "__main__":
    sys.exit(main())
