#!/usr/bin/env python3
"""The MoE combine's backward on one NVIDIA card: its stream body against
the plain version, in variants, beside the warp_row body it replaced, any
other build of the same entry and the library.

    python3 tools/combine_bwd_probe.py [VARIANT ...] [--against FILE ...]
                                       [--check-only] [--iters N]
                                       [--seed S]

Prints the card's name and power limit first.  Builds
``src/repro_torch/csrc/segment_bwd.cu`` as it is ("base"), once per named
variant below (a list of source edits, each of which must find its text
once) and once per ``--against`` file (another ``segment_bwd.cu`` with the
entry ``moe_combine_bwd`` of the same arguments: the parent tree's is
``mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent``,
then ``--against build/parent/src/repro_torch/csrc/segment_bwd.cu``), all
nvcc runs in parallel, and prints ptxas's registers, spills and shared
memory for each build's kernels.

The operands are ``chip_smoke.py`` phase 17 (d)'s: the combine's inputs
at layer 0 of a granite-moe-1b-a400m training microbatch (4 x 4,096
tokens, full width, bf16, random weights from ``--seed``, captured at
the first ``moe_combine`` of ``train_loss``; 131,072 slots into 16,384
tokens over 163,840 rows of 1,024), g from a seeded generator.  The
smoke captures them after 4 AdamW steps and the probe at the initial
weights, so the kept-slot count differs a little; both print it.

Each build is held to the plain version (grad_eo bit-equal, grad_w
within relative L1 1e-5, a relaunch bit-identical) and to base's bits;
an ablation computes something else, and its numbers are printed, not
checked.  Unless ``--check-only``, every build, the warp_row body (the
package's private entry, counted nowhere) and the library yardstick
(``index_add_`` of the weighted rows plus a ``bmm`` of the row dots) are
timed with CUDA events, a mean of ``--iters`` calls, in two rounds, the
second in reverse order, beside the byte bound (each input byte read
once, each output byte written once, over 3.35 TB/s).

Variants, each keeping every output's bits: ``split`` (all slot CTAs
first, then the row CTAs, not interleaved), ``run4`` / ``run16`` (slots a
slot warp, not 8), ``cs_owned`` (the owned rows of grad_eo by streaming
stores too), ``cta256`` (256 threads a CTA, not 128), ``warps24``
(launch bounds asking for 24 warps an SM), ``ahead2`` / ``ahead3`` (eo
rows in flight beyond the one summed, not 1), ``steps2`` (tiles of two
16-byte pieces a lane, not 4), ``ldcs`` (eo's rows read with the
evict-first hint), ``g_twice`` (the slot warps write no grad_eo row; the
row warps write every row, rereading g for the owned ones, as the
warp_row body does: the second read of g in the same launch), ``bulk`` /
``bulk4`` (bf16 rows of up to 1,024 columns on another body,
``BULK_BODY``: persistent CTAs, one an SM, a producer warp copying each
run's rows and its token's g row by TMA bulk copies into a ring of 10
stages, 8 or 4 consumer warps).  Ablations: ``no_zero`` (the row warps
write nothing), ``no_gather`` (no eo row is read: the dots run on
zeros), ``g_each`` (g loaded again for every slot, not once a token),
``no_owned`` (the slot warps write no grad_eo row).  With no argument,
none.  Exits non-zero without a card or when a check fails.
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

OUT = ROOT / "build" / "combine_bwd_probe"
# the `bulk` variants' body: persistent CTAs, one an SM, a producer warp
# that copies each run's eo rows and its first token's g row by TMA bulk
# copies into a ring of stages, consumer warps that sum the dots from
# shared memory (g in registers, the same order as the stream body's) and
# write the owned rows, then the rows no slot owns; bf16 rows of up to one
# tile (32 * kSteps * 8 columns)
BULK_BODY = """
constexpr int kBulkConsumers = %(consumers)d;
constexpr int kBulkStages = %(stages)d;
constexpr int kBulkThreads = 32 * (kBulkConsumers + 1);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%%0], %%1;\\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%%0], %%1;\\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%%0];\\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\nmbarrier.try_wait.parity.shared::cta.b64 p, [%%1], %%2;\\n"
        "selp.u32 %%0, 1, 0, p;\\n}\\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%%0], [%%1], %%2, [%%3];\\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
combine_bwd_bulk_kernel(const __nv_bfloat16* __restrict__ eo, const float* __restrict__ g,
                        const float* __restrict__ w, const int64_t* __restrict__ rows,
                        const int32_t* __restrict__ seg, const int64_t* __restrict__ slot,
                        float* __restrict__ grad_w, __nv_bfloat16* __restrict__ grad_eo,
                        int64_t n_slots, int64_t n_rows, int d) {
  using V = Vec16<__nv_bfloat16>;
  constexpr int VEC = 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = d * 2, g_bytes = d * 4;
  const int stage_bytes = kRun * row_bytes + g_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)kBulkStages * stage_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kBulkStages; ++st) {
      mbar_init(smem_u32(bars + st), 1);
      mbar_init(smem_u32(bars + kBulkStages + st), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  const int64_t n_runs = (n_slots + kRun - 1) / kRun;
  if (warp == kBulkConsumers) {  // the producer: lanes hold 4 runs' rows
    int64_t cr = 0;
    int ct = 0;
    {
      const int64_t run = blockIdx.x + (int64_t)(lane / 8) * gridDim.x;
      const int64_t s = run * kRun + lane %% 8;
      if (run < n_runs && s < n_slots) {
        cr = rows[s];
        ct = seg[run * kRun];
      }
    }
    for (int k0 = 0; blockIdx.x + (int64_t)k0 * gridDim.x < n_runs; k0 += 4) {
      int64_t nr = 0;
      int nt = 0;
      {
        const int64_t run = blockIdx.x + (int64_t)(k0 + 4 + lane / 8) * gridDim.x;
        const int64_t s = run * kRun + lane %% 8;
        if (run < n_runs && s < n_slots) {
          nr = rows[s];
          nt = seg[run * kRun];
        }
      }
      for (int q = 0; q < 4; ++q) {
        const int it = k0 + q;
        const int64_t run = blockIdx.x + (int64_t)it * gridDim.x;
        if (run >= n_runs) break;
        const int st = it %% kBulkStages;
        const int64_t s0 = run * kRun;
        const int cnt = (int)(n_slots - s0 < kRun ? n_slots - s0 : kRun);
        if (it >= kBulkStages)
          mbar_wait(smem_u32(bars + kBulkStages + st), (it / kBulkStages - 1) & 1);
        unsigned char* base = smem + (size_t)st * stage_bytes;
        const int t = __shfl_sync(kFull, ct, q * 8);
        if (lane == 0) {
          mbar_expect_tx(smem_u32(bars + st), cnt * row_bytes + g_bytes);
          bulk_load(smem_u32(base + kRun * row_bytes), g + (int64_t)t * d, g_bytes,
                    smem_u32(bars + st));
        }
        __syncwarp();
        if (lane / 8 == q && lane %% 8 < cnt)
          bulk_load(smem_u32(base + (lane %% 8) * row_bytes), eo + (cr < 0 ? 0 : cr) * d,
                    row_bytes, smem_u32(bars + st));
      }
      cr = nr;
      ct = nt;
    }
    return;
  }
  for (int it = warp;; it += kBulkConsumers) {
    const int64_t run = blockIdx.x + (int64_t)it * gridDim.x;
    if (run >= n_runs) break;
    const int st = it %% kBulkStages;
    const int64_t s0 = run * kRun;
    const int cnt = (int)(n_slots - s0 < kRun ? n_slots - s0 : kRun);
    long long my_row = 0;
    int my_seg = 0, my_own = 0;
    float my_w = 0.0f;
    if (lane < cnt) {
      my_row = rows[s0 + lane];
      my_seg = seg[s0 + lane];
      my_w = w[s0 + lane];
      my_own = my_row >= 0 && my_row < n_rows && slot[my_row] == s0 + lane;
    }
    mbar_wait(smem_u32(bars + st), (it / kBulkStages) & 1);
    const unsigned char* base = smem + (size_t)st * stage_bytes;
    float gv[kSteps * VEC];
    const float4* g_s = reinterpret_cast<const float4*>(base + kRun * row_bytes);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int c = (j * 32 + lane) * VEC;
      if (c < d) {
        const float4 f0 = g_s[c / 4], f1 = g_s[c / 4 + 1];
        gv[j * VEC] = f0.x;
        gv[j * VEC + 1] = f0.y;
        gv[j * VEC + 2] = f0.z;
        gv[j * VEC + 3] = f0.w;
        gv[j * VEC + 4] = f1.x;
        gv[j * VEC + 5] = f1.y;
        gv[j * VEC + 6] = f1.z;
        gv[j * VEC + 7] = f1.w;
      }
    }
    int held = __shfl_sync(kFull, my_seg, 0);
    float acc[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < cnt && __shfl_sync(kFull, my_row, i) >= 0) {  // a dropped slot: dot 0
        const int sg = __shfl_sync(kFull, my_seg, i);
        if (sg != held) {
          load_g<VEC>(gv, g + (int64_t)sg * d, lane, d);
          held = sg;
        }
        const __nv_bfloat16* er = reinterpret_cast<const __nv_bfloat16*>(base + i * row_bytes);
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int c = (j * 32 + lane) * VEC;
          if (c < d) {
            float e[VEC];
            V::unpack(*reinterpret_cast<const uint4*>(er + c), e);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[i] = fmaf(e[v], gv[j * VEC + v], acc[i]);
          }
        }
        if (__shfl_sync(kFull, my_own, i)) {
          const float ws = __shfl_sync(kFull, my_w, i);
          __nv_bfloat16* out = grad_eo + __shfl_sync(kFull, my_row, i) * d;
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            const int c = (j * 32 + lane) * VEC;
            if (c < d) {
              float v[VEC];
#pragma unroll
              for (int q = 0; q < VEC; ++q) v[q] = ws * gv[j * VEC + q];
              *reinterpret_cast<uint4*>(out + c) = V::pack(v);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(bars + kBulkStages + st));
    float mine = 0.0f;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      float a = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
      if (lane == i) mine = a;
    }
    if (lane < cnt) grad_w[s0 + lane] = mine;
  }
  for (int64_t wid = (int64_t)blockIdx.x * kBulkConsumers + warp; wid * kRowsPerWarp < n_rows;
       wid += (int64_t)gridDim.x * kBulkConsumers)
    row_warp<__nv_bfloat16>(wid, lane, g, w, rows, seg, slot, grad_eo, n_slots, n_rows, d);
}

int launch_bulk(const void* eo, const float* g, const float* w, const int64_t* rows,
                const int32_t* seg, const int64_t* slot, float* grad_w, void* grad_eo,
                int64_t n_slots, int64_t n_rows, int d, cudaStream_t stream) {
  const int smem = kBulkStages * (kRun * d * 2 + d * 4) + 2 * kBulkStages * 8;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err = cudaFuncSetAttribute(
      combine_bwd_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  combine_bwd_bulk_kernel<<<sms, kBulkThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(eo), g, w, rows, seg, slot, grad_w,
      static_cast<__nv_bfloat16*>(grad_eo), n_slots, n_rows, d);
  return cudaGetLastError();
}

"""
_WARP_ROW = "int warp_row(const void* eo, int dtype,"
_BF16_ROUTE = ("  if (dtype == 1 && vec == 8)\n"
               "    return launch_stream<__nv_bfloat16>")


def _bulk(consumers, stages):
    return [(_WARP_ROW, BULK_BODY % {"consumers": consumers,
                                     "stages": stages} + _WARP_ROW),
            (_BF16_ROUTE,
             "  if (dtype == 1 && vec == 8 && d <= 32 * kSteps * 8)\n"
             "    return launch_bulk(eo, g, w, rows, seg, slot, grad_w, "
             "grad_eo, n_slots, n_rows, d, st);\n" + _BF16_ROUTE)]


_OWNED_STORE = "*reinterpret_cast<uint4*>(out + c) = V::pack(v);"
_ROW_TODO = "todo = !(named && rows[s] == r);"
_OWNS = "if (__shfl_sync(kFull, my_own, i)) {"
VARIANTS = {
    "split": [("constexpr bool kInterleave = true;",
               "constexpr bool kInterleave = false;")],
    "run4": [("constexpr int kRun = 8;", "constexpr int kRun = 4;")],
    "run16": [("constexpr int kRun = 8;", "constexpr int kRun = 16;")],
    "cs_owned": [(_OWNED_STORE,
                  "__stcs(reinterpret_cast<uint4*>(out + c), V::pack(v));")],
    "cta256": [("constexpr int kThreads = 128;",
                "constexpr int kThreads = 256;")],
    "warps24": [("__global__ void __launch_bounds__(kThreads)\n"
                 "combine_bwd_stream_kernel",
                 "__global__ void __launch_bounds__(kThreads, 768 / kThreads)\n"
                 "combine_bwd_stream_kernel")],
    "g_twice": [(_ROW_TODO, "todo = true;"), (_OWNS, "if (false) {")],
    "no_zero": [(_ROW_TODO, "todo = false;")],
    "no_gather": [
        ("if (c < left) dst[j] = __ldg(reinterpret_cast<const uint4*>"
         "(src + c));",
         "if (c < left) dst[j] = make_uint4(0u, 0u, 0u, 0u);")],
    "g_each": [("if (!have || sg != held) {", "if (true) {")],
    "no_owned": [(_OWNS, "if (false) {")],
    "ahead2": [("constexpr int kAhead = 1;", "constexpr int kAhead = 2;")],
    "ahead3": [("constexpr int kAhead = 1;", "constexpr int kAhead = 3;")],
    "steps2": [("constexpr int kSteps = 4;", "constexpr int kSteps = 2;")],
    "ldcs": [("if (c < left) dst[j] = __ldg(reinterpret_cast<const uint4*>"
              "(src + c));",
              "if (c < left) dst[j] = __ldcs(reinterpret_cast<const uint4*>"
              "(src + c));")],
    "bulk": _bulk(8, 10),
    "bulk4": _bulk(4, 10),
}
ABLATIONS = {"no_zero", "no_gather", "g_each", "no_owned"}
ARCH = "granite-moe-1b-a400m"
BATCH, SEQ = 4, 4096  # a microbatch of phase 17's train_4k cut


def edited_source(name, edits):
    """csrc/segment_bwd.cu with ``edits`` made; each must find its text
    once."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "segment_bwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"combine_bwd_probe: {name}: {old!r} is in "
                             f"segment_bwd.cu {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(name, source):
    """nvcc of ``source`` into build/combine_bwd_probe/<name>/lib.so;
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
            short = re.search(r"combine_bwd_\w*?kernel(I\w*?E)?", kernel)
            lines.append(f"{name}: {short.group(0) if short else kernel}: "
                         f"{ln.split(':', 1)[-1].strip()}")
    return d / "lib.so", lines


def operands(torch, dev, seed):
    """Phase 17 (d)'s operands at the model's initial weights: ``(g,
    data, seg, w, rows, slot, n)``."""
    from chip_smoke import _capture_first

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_token_batch
    from repro_torch.models import transformer

    cfg = get_arch(ARCH).model_cfg
    model = transformer.init_params(cfg, seed=seed, device=dev)
    batch = lm_token_batch(0, BATCH, SEQ, cfg.vocab, seed=seed)
    ins = _capture_first(torch, transformer, "moe_combine",
                         lambda: transformer.train_loss(model, batch))
    data = ins["args"][0].detach()
    seg, n = ins["args"][1], ins["args"][2]
    w, rows, slot = (ins["kw"][x].detach() for x in ("weights", "rows",
                                                     "slot"))
    del model, ins
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, data.shape[1]), generator=gen, device=dev)
    return g, data, seg, w, rows, slot, n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--against", type=pathlib.Path, nargs="*", default=[])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        print(f"combine_bwd_probe: unknown variants {sorted(unknown)}; "
              f"known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("combine_bwd_probe: no card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    from chip_smoke import Timer, combine_bwd_bound, combine_bwd_library_ms

    from repro_torch.kernels import _build
    from repro_torch.kernels.segment import segment_sum_bwd_ref
    from repro_torch.kernels.segment.backward import (
        COMBINE_BWD_ROUTES, _lib, _moe_combine_bwd_warp_row, moe_combine_bwd)

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
        # typed as the package types its own (another build may lack the
        # warp_row entry, which only the package's library serves here)
        lib.moe_combine_bwd.argtypes = own.moe_combine_bwd.argtypes
        lib.moe_combine_bwd.restype = own.moe_combine_bwd.restype
        libs[name] = lib

    def through(lib):
        def run(*a):
            _build._LIBS["segment_bwd"] = lib
            try:
                return moe_combine_bwd(*a)
            finally:
                _build._LIBS["segment_bwd"] = own
        return run

    dev = torch.device("cuda")
    g, data, seg, w, rows, slot, n = operands(torch, dev, args.seed)
    ops = (g, data, seg, w, rows, slot)
    kept = int((w != 0).sum())
    b_ms, b_by, n_read = combine_bwd_bound(torch, data, seg, rows, n)
    print(f"operands: eo {tuple(data.shape)} {str(data.dtype)[6:]}, "
          f"{seg.numel()} slots into {n} tokens, {kept} of non-zero weight, "
          f"{n_read} rows named; bound {b_ms:.4f} ms ({b_by})", flush=True)
    want = segment_sum_bwd_ref(g, data, seg, w, rows)
    old = _moe_combine_bwd_warp_row(*ops)
    ok = True
    base = None
    for name, lib in libs.items():
        before = COMBINE_BWD_ROUTES["stream"]
        got = through(lib)(*ops)
        again = through(lib)(*ops)
        torch.cuda.synchronize()
        base = got if base is None else base
        e_w = float((got[0].double() - want[0].double()).abs().sum()
                    / want[0].double().abs().sum())
        exact = torch.equal(got[1], want[1])
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        bits = all(torch.equal(x, y) for x, y in zip(got, base))
        old_bits = all(torch.equal(x, y) for x, y in zip(got, old))
        good = name in ABLATIONS or (e_w <= 1e-5 and exact and same and bits)
        ok &= good
        print(f"  {name}: grad_w relative L1 {e_w:.3e} (bound 1e-5), "
              f"grad_eo bit-equal {exact}, relaunch bit-identical {same}, "
              f"base's bits {bits}, the warp_row body's bits {old_bits}, "
              f"stream launches {COMBINE_BWD_ROUTES['stream'] - before}: "
              + ("an ablation, not checked" if name in ABLATIONS
                 else "ok" if good else "FAILED"), flush=True)
        del got, again
    del want, old, base
    if args.check_only or not ok:
        return 0 if ok else 1

    timer = Timer(torch, dev)
    fns = {**{name: (lambda lib=lib: through(lib)(*ops))
              for name, lib in libs.items()},
           "warp_row body": lambda: _moe_combine_bwd_warp_row(*ops)}
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(timer(fns[k], args.iters))
    lib_ms = combine_bwd_library_ms(torch, timer, g, data, seg, w, rows,
                                    args.iters)
    for k, ms in got.items():
        print(f"{k}: {' / '.join(f'{t:.4f}' for t in ms)} ms a call "
              f"({100 * b_ms / min(ms):.1f} % of the {b_ms:.4f} ms bound at "
              "the least)", flush=True)
    print(f"library (index_add_ + bmm): {lib_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
