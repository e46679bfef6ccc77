#!/usr/bin/env python3
"""Where K7 (the simulator's push: ``sim_messages``, ``sim_push``) spends
its time, on one NVIDIA card.

    python3 tools/k7_probe.py [--against FILE ...] [--n N] [--steps S]
                              [--hubs M,M,...] [--against-hubs M]

Builds ``src/repro_torch/csrc/sim_push.cu`` as it is ("base"), once more
with the phase hooks it declares defined ("phases"), and each ``--against``
file (another ``sim_push.cu`` with the same C interface, such as a parent
commit's: ``git show HEAD~1:src/repro_torch/csrc/sim_push.cu``), all nvcc
runs in parallel.  Runs the simulator (K=8, the batch schedule,
``host_block_graph(N, seed=0)``, ``tools/sim_probe.capture_pushes``) for S
steps and keeps the largest and the median push (by messages), then for
each build in turn, through the wrapper with that build's library in
place of its own:

- both kernels at both pushes, held to their plain versions' bits, timed
  by CUDA events (the least of two 50-call means, the second round in
  reverse order, the greatest in brackets), beside ``index_add_``;
- ``sim_push`` on hubs (one key given each of the ``--hubs`` message
  counts, of 2M messages over a 2M-entry state), held to the plain
  version's bits and timed beside ``index_add_`` (the least of two 3-call
  means); an ``--against`` build only up to ``--against-hubs`` messages
  (10**5 by default, for a design whose ordering of a long bucket costs
  m**2 loads);
- for ``phases``, at both pushes and on the hubs: the device time of each
  phase between the kernels' grid barriers (``%globaltimer`` read by CTA
  0 after each barrier, summed over the calls), the rest (the last phase
  and the launch) being the mean less their sum; then the floor of
  ``sim_push``'s last phase: the ns an add of one warp's chain of
  dependent float64 adds (as many as the largest hub), its operands from
  registers and, as that phase has them, from shared memory.

Then the host's microseconds a call (200 calls enqueued, then one
synchronize) of each wrapper and of its pieces: the argument checks, the
stream handle, three ``torch.empty``, the ctypes call that launches
nothing (an empty push), and the whole call.  Prints the card's name and
power limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

# defines the hooks K7_START / K7_STAMP that csrc/sim_push.cu declares
# (empty there): CTA 0's thread 0 adds the %globaltimer time since the last
# stamp into k7_phase[slot], the slot one up at each stamp
STAMPS = r"""#include <cuda_runtime.h>
__device__ unsigned long long k7_phase[16];
__device__ __forceinline__ unsigned long long k7_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K7_START(slot) unsigned long long k7_t = k7_now(); int k7_k = (slot)
#define K7_STAMP                                                  \
  do {                                                            \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                    \
      const unsigned long long k7_n = k7_now();                   \
      atomicAdd(k7_phase + k7_k, k7_n - k7_t);                    \
      k7_t = k7_n;                                                \
    }                                                             \
    ++k7_k;                                                       \
  } while (0)
extern "C" int k7_phase_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k7_phase, sizeof(k7_phase));
}
extern "C" int k7_phase_zero() {
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(k7_phase, zero, sizeof(zero));
}
// the floor of phase E: one warp adds n values in one chain (__dadd_rn),
// its operands from registers (staged == 0) or, as phase E has them, from
// a chunk of 32 staged in shared memory (staged == 1)
__global__ void k7_chain_kernel(const double* x, int n, int staged, double* out) {
  __shared__ double stage[32];
  const int lane = threadIdx.x;
  double acc = 0.0, r[4];
  for (int q = 0; q < 4; ++q) r[q] = x[q];
  for (int c = 0; c < n; c += 32) {
    if (staged) {
      __syncwarp();
      stage[lane] = x[c + lane];
      __syncwarp();
#pragma unroll
      for (int l = 0; l < 32; ++l) acc = __dadd_rn(acc, stage[l]);
    } else {
#pragma unroll
      for (int l = 0; l < 32; ++l) acc = __dadd_rn(acc, r[l & 3]);
    }
  }
  if (lane == 0) *out = acc;
}
extern "C" int k7_chain(const void* x, int n, int staged, void* out, void* stream) {
  k7_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const double*)x, n, staged,
                                                       (double*)out);
  return (int)cudaGetLastError();
}
"""
# the phases each kernel's stamps close (slots of k7_phase)
PHASES = {"sim_push": {0: "A ranks", 1: "B settle", 2: "C scatter",
                       3: "D chunk order", 4: "M merges"},
          "sim_messages": {8: "1 degrees", 9: "2 prefix, tiles"}}
OUT = ROOT / "build" / "k7_probe"


def build(name, source, include=None):
    """nvcc of ``source`` into OUT/name/lib.so, with ``include`` (a
    header's text) force-included first."""
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "sim_push.cu").write_text(pathlib.Path(source).read_text())
    extra = []
    if include is not None:
        (d / "hooks.h").write_text(include)
        extra = ["-include", str(d / "hooks.h")]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o",
                           str(d / "lib.so"), str(d / "sim_push.cu")],
                          capture_output=True, text=True)
    errors = [ln for ln in (proc.stdout + proc.stderr).splitlines()
              if "error" in ln or "Used" in ln]
    return name, proc.returncode, errors


def phase_times(torch, timer, lib, kname, fn, calls):
    """Prints ``kname``'s device time a call by phase (the stamps of the
    `phases` build, summed over ``calls`` calls)."""
    stamps = (ctypes.c_ulonglong * 16)()
    lib.k7_phase_zero()
    mean = timer(fn, calls, warmup=0)
    lib.k7_phase_read(stamps)
    us = {PHASES[kname][k]: stamps[k] / calls / 1e3 for k in PHASES[kname]}
    print(f"  {kname} {mean * 1e3:.1f} us: " + ", ".join(
        f"{k} {v:.1f}" for k, v in us.items())
        + f", rest {mean * 1e3 - sum(us.values()):.1f}")


def chain_floor(torch, timer, lib, n):
    """Prints the ns an add of one warp's chain of ``n`` dependent float64
    adds takes, its operands from registers and from shared memory."""
    from repro_torch.kernels import _build

    n = (n + 31) // 32 * 32
    x = torch.rand(n + 32, dtype=torch.float64, device="cuda")
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    stream = _build.stream_handle(x.device)
    lib.k7_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    got = {}
    for staged, what in ((0, "registers"), (1, "shared memory")):
        ms = timer(lambda: lib.k7_chain(x.data_ptr(), n, staged,
                                        out.data_ptr(), stream), 3)
        got[what] = ms * 1e6 / n
    print(f"  a chain of {n} float64 adds by one warp, ns an add: " +
          ", ".join(f"operands from {k} {v:.2f}" for k, v in got.items()))


def hub_push(m, torch, device, seed=0):
    """One key (1234) given ``m`` of 2M messages over a 2M-entry state, the
    other messages on random keys: ``(state, key, msg)`` on ``device``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    e = max(2 * 10**6, m)
    key = rng.integers(0, 2 * 10**6, e).astype(np.int32)
    key[rng.permutation(e)[:m]] = 1234
    msg = rng.standard_normal(e) * 10.0 ** rng.uniform(-9, 2, e)
    state = rng.standard_normal(2 * 10**6)
    return [torch.as_tensor(a, device=device) for a in (state, key, msg)]


def host_us(torch, fn, calls=200):
    """Host microseconds a call: ``calls`` calls enqueued, then one
    synchronize (outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def main() -> int:
    import torch

    import chip_smoke
    import repro_torch
    import sim_probe
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.sim_push import kernel as k7

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another sim_push.cu to build and time")
    ap.add_argument("--n", type=int, default=2**21)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--hubs", default="10000,100000,1000000",
                    help="messages of the one hub key, comma-separated")
    ap.add_argument("--against-hubs", type=int, default=10**5,
                    help="the largest hub an --against build is given")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(smi)
    base = _build.CSRC / "sim_push.cu"
    builds = {"base": (base, None), "phases": (base, STAMPS),
              **{f"against{i}": (f, None)
                 for i, f in enumerate(args.against)}}
    with cf.ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda n: build(n, *builds[n]), builds))
    for name, rc, lines in built:
        print(f"{name} ({builds[name][0]}): nvcc exit {rc}" + "".join(
            f"\n  {ln.strip()}" for ln in lines))
    if any(rc for _, rc, _ in built):
        return 1
    for name in _build.build_all():
        _build.library(name)
    real = k7._lib()
    libs = {}
    for name in builds:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fname in ("sim_push", "sim_messages", "sim_push_rows",
                      "sim_push_scratch", "sim_messages_scratch"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    t0 = time.perf_counter()
    problem = repro_torch.Problem.pagerank(host_block_graph(args.n, seed=0))
    sim, pushes = sim_probe.capture_pushes(problem, args.steps, torch)
    print(f"set-up {time.perf_counter() - t0:.1f} s, {len(pushes)} pushes")
    timer = chip_smoke.Timer(torch, torch.device("cuda"))
    dev = sim._state.device
    hubs = [int(m) for m in args.hubs.split(",") if m]
    hub_want = {}
    for m in hubs:
        state, key, msg = hub_push(m, torch, "cpu")
        k7.sim_push_plain(state, key, msg)
        hub_want[m] = state
    own_lib = k7._lib
    try:
        for name, lib in libs.items():
            k7._lib = lambda lib=lib: lib
            for what, push in (("largest", pushes[-1]),
                               ("median", pushes[len(pushes) // 2])):
                sel, pid, sent, n_e = push[:4]
                m_args = (sel, pid, sent, sim.deg, sim.indptr, sim.indices,
                          sim.edge_w, sim.owner, n_e)
                got = k7.sim_messages(*m_args)
                state = torch.zeros_like(sim._state)
                summed = state.clone()
                k7.sim_push(summed, got[0], got[1])
                cpu = [a.cpu() if torch.is_tensor(a) else a for a in m_args]
                want = k7.sim_messages_plain(*cpu)
                ref = state.cpu()
                k7.sim_push_plain(ref, want[0], want[1])
                same = all(torch.equal(a.cpu(), w)
                           for a, w in zip((*got, summed), (*want, ref)))
                key, msg = got[0], got[1]
                fns = {"sim_messages": lambda: k7.sim_messages(*m_args),
                       "sim_push": lambda: k7.sim_push(state, key, msg),
                       "index_add_": lambda: state.index_add_(0, key, msg)}
                t = chip_smoke.least(timer, fns, 50)
                print(f"{name} {what} push ({sel.numel()} nodes, {n_e} "
                      f"messages, longest bucket "
                      f"{int(torch.bincount(key).max())}): bits equal to "
                      f"the plain versions {same}; " + ", ".join(
                          f"{k} {lo:.4f} [{hi:.4f}] ms"
                          for k, (lo, hi) in t.items()))
                if name == "phases":
                    for kname in ("sim_messages", "sim_push"):
                        phase_times(torch, timer, lib, kname, fns[kname], 50)
            for m in hubs:
                if name.startswith("against") and m > args.against_hubs:
                    continue
                state, key, msg = hub_push(m, torch, dev)
                got = state.clone()
                k7.sim_push(got, key, msg)
                same = torch.equal(got.cpu(), hub_want[m])
                fns = {"sim_push": lambda: k7.sim_push(got, key, msg),
                       "index_add_": lambda: got.index_add_(0, key, msg)}
                t = chip_smoke.least(timer, fns, 3)
                print(f"{name} hub of {m} messages ({key.numel()} in all): "
                      f"bits equal to the plain version {same}; " + ", ".join(
                          f"{k} {lo:.4f} [{hi:.4f}] ms"
                          for k, (lo, hi) in t.items()))
                if name == "phases":
                    phase_times(torch, timer, lib, "sim_push",
                                fns["sim_push"], 3)
            if name == "phases":
                chain_floor(torch, timer, lib, max(hubs))
    finally:
        k7._lib = own_lib

    # the host's cost a call, at the median push
    sel, pid, sent, n_e = pushes[len(pushes) // 2][:4]
    m_args = (sel, pid, sent, sim.deg, sim.indptr, sim.indices, sim.edge_w,
              sim.owner, n_e)
    key, msg, _ = k7.sim_messages(*m_args)
    state = torch.zeros_like(sim._state)
    dev = state.device
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    pieces = {
        "sim_messages": lambda: k7.sim_messages(*m_args),
        "sim_push": lambda: k7.sim_push(state, key, msg),
        "checks of sim_messages' 8 tensors": lambda: k7._check(
            dev, sel=(sel, torch.int64), pid=(pid, torch.int64),
            sent=(sent, torch.float64), deg=(sim.deg, torch.int64),
            indptr=(sim.indptr, torch.int64),
            indices=(sim.indices, torch.int64),
            wgt=(sim.edge_w, torch.float64), owner=(sim.owner, torch.int32)),
        "stream handle": lambda: _build.stream_handle(dev),
        "3 torch.empty": lambda: [torch.empty(n_e, dtype=torch.float64,
                                              device=dev) for _ in range(3)],
        "an empty push (no launch)": lambda: k7.sim_push(
            state, empty, msg[:0]),
        "index_add_": lambda: state.index_add_(0, key, msg),
    }
    print(f"host us a call at the median push ({n_e} messages): " + ", ".join(
        f"{k} {host_us(torch, fn):.1f}" for k, fn in pieces.items()))
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
