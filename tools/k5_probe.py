#!/usr/bin/env python3
"""Where K5 (the sorted segment sum) spends its time, on one NVIDIA card.

    python3 tools/k5_probe.py [VARIANT ...] [--gin-nodes N] [--json PATH]

Builds ``src/repro_torch/csrc/segment_sum.cu`` once as it is ("base") and
once per named variant below, each a list of source edits (every edit
must find its text, or the tool stops), all nvcc runs in parallel; loads
each build in turn in place of the wrapper's library and, at the shapes
of ``chip_smoke.py`` phase 10 (``gin-tu`` at ``ogb_products``: the
seed-0 ``power_law_graph(2,449,029, alpha=1.655)`` padded to N=2,449,056
and E=61,859,328, d=64, sorted by destination; the node states from a
seeded generator on the card), times (CUDA events, ``chip_smoke.Timer``;
the least of two rounds, the second in reverse order, the greatest in
brackets)

- the contiguous form on the ``[E, 64]`` messages ``h[src]``, unweighted
  beside ``torch.segment_reduce`` and weighted by the edge mask;
- the gather form (``rows = src``, the mask as weights: one GIN layer's
  aggregation) beside ``torch.sparse.mm`` of a ``sparse_csr`` matrix;

with the byte bounds beside them.  Each variant is first held to the
base build (relative L1 <= 1e-5; a variant that keeps the chunk size
must not change a bit).

Variants: ``chunk512``, ``chunk2048``, ``chunk4096``, ``chunk8192``
(sorted rows a CTA, not 1,024), ``stages3``, ``stages4`` (ring stages,
not 2), ``carry_in_launch`` (no second kernel: the last of a segment's
chunks to arrive on a counter adds its carries, in chunk order, in the
same launch).  With no argument, all of them.  ``--json PATH`` writes
every number there too.  Prints the card's name and power limit first;
exits non-zero without a card.
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

_BASE_CHUNK = "constexpr int kChunk = 1024;"
_BASE_STAGES = "constexpr int kStages = 2;"
_EMIT = """template <int VEC>
__device__ void emit(const Args& a, int s, const Vec<VEC>& v, bool last, int64_t c, int col) {
  if (s < 0 || s >= a.n) return;
  if (last && s == __ldg(a.plan + c + 1))
    put(a.carry + c * a.d + col, v);
  else
    put(a.out + (int64_t)s * a.d + col, v);
}"""
_EMIT_ARRIVE = """__device__ unsigned k5_arrivals[1 << 20];  // zeroed before each launch

template <int VEC>
__device__ void emit(const Args& a, int s, const Vec<VEC>& v, bool last, int64_t c, int col) {
  if (s < 0 || s >= a.n) return;
  const int64_t begin = __ldg(a.ptr + s);
  const int64_t from = begin / kChunk;  // the chunks the segment spans
  int64_t to = c;
  if (last && s == __ldg(a.plan + c + 1)) {
    put(a.carry + c * a.d + col, v);
    to = (__ldg(a.ptr + s + 1) - 1) / kChunk;
  } else {
    put(a.out + (int64_t)s * a.d + col, v);
    if (begin >= c * kChunk) return;
  }
  // the last of chunks from..to to arrive adds their carries
  const int n_act = min(a.lanes, a.units - (int)blockIdx.y * a.lanes);
  const unsigned mask = n_act == 32 ? 0xffffffffu : (1u << n_act) - 1u;
  __threadfence();
  __syncwarp(mask);
  unsigned done = 0;
  if ((threadIdx.x & 31) == 0)
    done = atomicAdd(k5_arrivals + to * gridDim.y + blockIdx.y, 1u) == (unsigned)(to - from);
  done = __shfl_sync(mask, done, 0);
  if (!done) return;
  __threadfence();
  combine<VEC>(a, s, from, to, col);
}"""
_LAUNCH = """  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4: return by_index<4>(a, idx_bytes, n_chunks, tiles, st);"""
_LAUNCH_ZEROED = """  cudaStream_t st = (cudaStream_t)stream;
  if (n_chunks * tiles > (1 << 20)) return cudaErrorInvalidValue;
  void* arrivals = nullptr;
  err = cudaGetSymbolAddress(&arrivals, k5_arrivals);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(arrivals, 0, n_chunks * tiles * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  switch (vec) {
    case 4: return by_index<4>(a, idx_bytes, n_chunks, tiles, st);"""
_CARRY = "  const int64_t blocks = (n_chunks + kThreads / lanes - 1) / (kThreads / lanes);"
# name: (source edits, rows a chunk)
VARIANTS = {
    **{f"chunk{c}": ([(_BASE_CHUNK, f"constexpr int kChunk = {c};")], c)
       for c in (512, 2048, 4096, 8192)},
    **{f"stages{s}": ([(_BASE_STAGES, f"constexpr int kStages = {s};")], 1024)
       for s in (3, 4)},
    "carry_in_launch": ([(_EMIT, _EMIT_ARRIVE), (_LAUNCH, _LAUNCH_ZEROED),
                         (_CARRY, "  return cudaSuccess;  // added in segment_sum's "
                          "launch\n" + _CARRY)], 1024),
}
OUT = ROOT / "build" / "k5_probe"


def build(name, edits):
    from repro_torch.kernels import _build

    src = (_build.CSRC / "segment_sum.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k5_probe: {name}: no {old!r} in segment_sum.cu")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "segment_sum.cu").write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "segment_sum.cu")],
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


def main() -> int:
    import torch

    from chip_smoke import (
        GIN_ALPHA, HBM_BYTES_PER_S, REL_L1, Timer, nvidia_smi, rel_l1)
    from repro_torch.configs import gin_tu
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.core import power_law_graph
    from repro_torch.data import make_gnn_batch, pad_gnn_batch
    from repro_torch.kernels.segment import chunk_plan, segment_sum_kernel
    from repro_torch.kernels.segment import kernel as k5
    from repro_torch.models import gnn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of them")
    ap.add_argument("--gin-nodes", type=int, default=None,
                    help="nodes of the GIN graph (default: the cell's)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    wanted = args.variants or list(VARIANTS)
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        print(f"k5_probe: no variant {sorted(unknown)}; there are "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    variants = {"base": ([], k5.CHUNK_ROWS),
                **{n: VARIANTS[n] for n in wanted}}
    with cf.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda n: build(n, variants[n][0]), variants))
    for name, rc, errors in built:
        print(f"{name}: nvcc exit {rc}" + "".join(f"\n  {e}" for e in errors))
    if any(rc for _, rc, _ in built):
        return 1

    own_lib, own_chunk = k5._lib, k5.CHUNK_ROWS
    real = own_lib()
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fname in ("segment_sum", "segment_sum_carry"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    def use(name):
        k5._lib = lambda: libs[name]
        k5.CHUNK_ROWS = variants[name][1]

    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    dims = SHAPE_DIMS["ogb_products"]
    cfg = gin_tu.cfg_for("ogb_products")
    n_real = args.gin_nodes or dims["n_real"]
    t0 = time.perf_counter()
    g = power_law_graph(n_real, alpha=GIN_ALPHA, seed=0)
    gb = make_gnn_batch(g, cfg.d_feat, n_classes=cfg.n_classes, seed=0)
    if n_real == dims["n_real"]:
        n, e = dims["n"], dims["e"]
    else:
        n, e = -(-g.n // 32) * 32, -(-g.n_edges // 512) * 512
    p = gnn.prepare_batch(pad_gnn_batch(gb, n, e), dev)
    del g, gb
    src, seg, w, ptr = p["agg_src"], p["agg_dst"], p["agg_w"], p["agg_ptr"]
    d = cfg.d_hidden
    h = torch.randn((n, d), generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    msgs = h.index_select(0, src)
    torch.cuda.synchronize()
    print(f"N={n} E={e} d={d}: longest segment "
          f"{int(torch.diff(ptr).max())} rows; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    plans = {c: chunk_plan(ptr, e, c) for _, c in variants.values()}
    lengths = torch.diff(ptr)
    lo, hi = int(ptr[0]), int(ptr[-1])
    a_csr = torch.sparse_csr_tensor(ptr - lo, src[lo:hi].long(), w[lo:hi],
                                    size=(n, n))

    def form(data, weights, rows):
        return lambda name: segment_sum_kernel(
            data, seg, n, weights, ptr, rows, plans[variants[name][1]])

    forms = {"contiguous": form(msgs, None, None),
             "weighted": form(msgs, w, None),
             "gather": form(h, w, src)}
    library = {
        "contiguous": lambda: torch.segment_reduce(msgs[lo:hi], "sum",
                                                   lengths=lengths),
        "gather": lambda: torch.sparse.mm(a_csr, h),
    }
    out_b, ptr_b = n * d * 4, ptr.numel() * 8
    bounds = {  # bytes: each input read once, the output written once
        "contiguous": msgs.numel() * 4 + ptr_b + out_b,
        "weighted": msgs.numel() * 4 + e * 4 + ptr_b + out_b,
        "gather": h.numel() * 4 + 2 * e * 4 + ptr_b + out_b,
    }
    result = {"device": smi, "n": n, "e": e, "d": d, "forms": {}}
    for fname, fn in forms.items():
        use("base")
        base = fn("base")
        for name in variants:
            use(name)
            got = fn(name)
            err = rel_l1(got, base)
            same = torch.equal(got, base)
            print(f"{fname} {name}: rel L1 {err:.3e} against base, "
                  f"bit-identical {same}")
            if err > REL_L1 or (variants[name][1] == own_chunk and not same):
                raise SystemExit(f"k5_probe: {fname} {name} disagrees with "
                                 "the base build")
            del got
        fns = {name: (lambda name=name: (use(name), fn(name)))
               for name in variants}
        if fname in library:
            fns["library"] = library[fname]
            lib_out = library[fname]()
            print(f"{fname}: library vs base max abs diff "
                  f"{float((lib_out - base).abs().max()):.3e}")
            del lib_out
        del base
        times = least(timer, fns, 10)
        b_ms = bounds[fname] / HBM_BYTES_PER_S * 1e3
        result["forms"][fname] = {"bound_ms": b_ms, "times": times}
        lib_ms = times.get("library", (None,))[0]
        print(f"== {fname}: bound {b_ms:.4f} ms ({bounds[fname] / 1e9:.3f} "
              "GB)" + (f"; library {lib_ms:.4f} ms [{times['library'][1]:.4f}]"
                       if lib_ms else "") + f" on {smi}")
        for name in variants:
            t, worst = times[name]
            print(f"  {name}: {t:.4f} ms [{worst:.4f}]  x{t / b_ms:.3f} "
                  "bound" + (f", x{t / lib_ms:.3f} library" if lib_ms
                             else ""), flush=True)
    k5._lib, k5.CHUNK_ROWS = own_lib, own_chunk
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
