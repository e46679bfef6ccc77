#!/usr/bin/env python3
"""Where K5 (the sorted segment sum) spends its time, on one NVIDIA card.

    python3 tools/k5_probe.py [VARIANT ...] [--parent DIR] [--gin-nodes N]
                              [--json PATH]

Builds ``src/repro_torch/csrc/segment_sum.cu`` once as it is ("base") and
once per named source variant below (each a list of edits: every edit
must find its text, or the tool stops), all nvcc runs in parallel; loads
each build in turn in place of the wrapper's library and times it (CUDA
events, ``chip_smoke.Timer``; the least of two rounds, the second in
reverse order, the greatest in brackets) at

- the MoE combine of qwen2-moe-a2.7b (``chip_smoke.py`` phase 16, layer
  0's shapes: 60 experts padded to 64, top-4, D = 2,048, bf16 expert
  outputs ``[64·cap, D]``, rows ``e·cap + pos``, the dropped slots at row
  0 and weight 0, from a seeded routing): A's prefill (16,384 tokens, cap
  1,366) and A's decode step (8 tokens, cap 1), each eager (the whole
  wrapper call) and by CUDA graph replay (``Timer.graphed``), beside
  ``torch.sparse.mm`` of a sparse_csr of the gate weights in bf16;
- ``chip_smoke.py`` phase 10's GIN layer (``gin-tu`` at ``ogb_products``:
  the seed-0 ``power_law_graph(2,449,029, alpha=1.655)`` padded to
  N=2,449,056 and E=61,859,328, d=64, sorted by destination; the node
  states from a seeded generator on the card): the contiguous form on the
  ``[E, 64]`` messages ``h[src]``, unweighted beside
  ``torch.segment_reduce`` and weighted by the edge mask, and the gather
  form (``rows = src``, the mask as weights) beside ``torch.sparse.mm``;

with the byte bounds beside them (each input read once, the output
written once).  Each variant is first held to the base build (relative L1
<= 1e-5; one that keeps the chunk size, and so every sum's order, must
not change a bit).

``--parent DIR``: DIR holds another tree of the repository (a parent
commit: ``git archive HEAD~1 | tar -x -C build/parent``), whose K5 may
have another C interface.  Each tree's package then runs in a subprocess
of its own (``--worker``), in turns, parent, this, this, parent, at the
same shapes, eager and by graph (GIN eager), on the same inputs (the GIN
layer's saved once under ``build/k5_probe/``), this tree's also beside
the library calls.  A tree whose wrapper takes the row ranges and the
plan from its caller gets them built once at the GIN layer, as its
prepared batch gave them, and not at the MoE shapes, where its model did
not pass them.

Variants: ``chunk512``, ``chunk2048``, ``chunk4096`` (sorted rows a CTA,
not 1,024), ``stages3``, ``stages4`` (ring stages, not 2).  With no
argument, all of them.  ``--json
PATH`` writes every number there too.  Prints the card's name and power
limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_BASE_CHUNK = "constexpr int kChunk = 1024;"
_BASE_STAGES = "constexpr int kStages = 2;"
# name: (source edits, rows a chunk)
VARIANTS = {
    **{f"chunk{c}": ([(_BASE_CHUNK, f"constexpr int kChunk = {c};")], c)
       for c in (512, 2048, 4096)},
    **{f"stages{s}": ([(_BASE_STAGES, f"constexpr int kStages = {s};")], 1024)
       for s in (3, 4)},
}
OUT = ROOT / "build" / "k5_probe"
# qwen2-moe-a2.7b's MoE layer: routed experts, padded, top-k, width
MOE = {"experts": 60, "e_pad": 64, "top_k": 4, "d": 2048, "factor": 1.25}
MOE_TOKENS = {"moe_prefill": 16384, "moe_decode": 8}


def edited_source(name, edits):
    """segment_sum.cu with a variant's edits; stops if one misses its
    text."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "segment_sum.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k5_probe: {name}: no {old!r} in "
                             "segment_sum.cu")
        src = src.replace(old, new)
    return src


def build(name, edits):
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "segment_sum.cu").write_text(edited_source(name, edits))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "segment_sum.cu")],
                          capture_output=True, text=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    errors = [ln for ln in lines if "error" in ln]
    # each kernel instance's registers and shared memory, from -Xptxas -v
    regs, kern = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            kern = ln.split("'")[1].split("segment_")[-1][:40]
        elif kern and "Used" in ln:
            regs.append(f"  {kern}: {ln.split(':', 1)[-1].strip()}")
            kern = None
    return name, proc.returncode, errors + regs


def moe_inputs(torch, dev, tokens, seed=0):
    """The combine's operands at ``tokens`` tokens: ``(eo [64·cap, D] bf16,
    seg [T·k] int32, n, weights [T·k] float32, rows [T·k] int64)`` from a
    seeded routing (k distinct experts a token, positions in token order,
    slots past ``cap`` dropped), made on the host with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    e, k, d = MOE["experts"], MOE["top_k"], MOE["d"]
    cap = int(np.ceil(tokens * k / e * MOE["factor"]))
    gate = np.argsort(rng.random((tokens, e)), axis=1)[:, :k].reshape(-1)
    pos = np.zeros(gate.size, np.int64)
    seen = np.zeros(e, np.int64)
    for i, x in enumerate(gate):  # each slot's place among its expert's
        pos[i] = seen[x]
        seen[x] += 1
    keep = pos < cap
    w = rng.random(gate.size).astype(np.float32)
    w = np.where(keep, torch.from_numpy(w).bfloat16().float().numpy(), 0.0)
    rows = np.where(keep, gate * cap + pos, 0)
    eo = torch.randn((MOE["e_pad"] * cap, d),
                     generator=torch.Generator(dev).manual_seed(seed),
                     device=dev).bfloat16()
    seg = torch.arange(tokens, dtype=torch.int32,
                       device=dev).repeat_interleave(k)
    return (eo, seg, tokens, torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(rows).to(dev))


def moe_library(torch, ins):
    """``torch.sparse.mm`` of the gate weights (sparse_csr, bf16) over the
    expert outputs: the library call of the same function."""
    eo, seg, n, w, rows = ins
    k = seg.numel() // n
    ptr = torch.arange(n + 1, device=eo.device) * k
    csr = torch.sparse_csr_tensor(ptr, rows, w.to(eo.dtype),
                                  size=(n, eo.shape[0]))
    return lambda: torch.sparse.mm(csr, eo)


def moe_bytes(ins):
    """Each row the slots name read once (the dropped ones name row 0),
    each slot's weight, row index and id; each token's float32 sum written
    once."""
    eo, seg, n, _, rows = ins
    e, d = seg.numel(), eo.shape[1]
    return (int(rows.unique().numel()) * d * 2 + e * (4 + 8 + 4)
            + n * d * 4)


def gin_inputs(torch, dev, n_real, save=None):
    """GIN's layer at ``n_real`` nodes: ``(h, seg, src, w, n, e)`` on the
    card, the graph built on the host (or loaded from ``save`` if it
    exists, else saved there)."""
    if save is not None and save.exists():
        p = torch.load(save)
    else:
        from chip_smoke import GIN_ALPHA
        from repro_torch.configs import gin_tu
        from repro_torch.configs.gnn_common import SHAPE_DIMS
        from repro_torch.core import power_law_graph
        from repro_torch.data import make_gnn_batch, pad_gnn_batch

        dims = SHAPE_DIMS["ogb_products"]
        cfg = gin_tu.cfg_for("ogb_products")
        g = power_law_graph(n_real, alpha=GIN_ALPHA, seed=0)
        gb = make_gnn_batch(g, cfg.d_feat, n_classes=cfg.n_classes, seed=0)
        if n_real == dims["n_real"]:
            n, e = dims["n"], dims["e"]
        else:
            n, e = -(-g.n // 32) * 32, -(-g.n_edges // 512) * 512
        gb = pad_gnn_batch(gb, n, e)
        order = gb["dst"].argsort(kind="stable")
        p = {"seg": torch.from_numpy(gb["dst"][order].astype("int32")),
             "src": torch.from_numpy(gb["src"][order].astype("int32")),
             "w": torch.from_numpy(gb["edge_mask"][order]), "n": n}
        if save is not None:
            save.parent.mkdir(parents=True, exist_ok=True)
            torch.save(p, save)
    seg, src, w = (p[k].to(dev) for k in ("seg", "src", "w"))
    n = int(p["n"])
    h = torch.randn((n, 64), generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    return h, seg, src, w, n, seg.numel()


def least(timer, fns, iters):
    """{name: (least, greatest)} ms over two rounds, the second reversed."""
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(timer(fns[k], iters))
    return {k: (min(v), max(v)) for k, v in got.items()}


def worker(args) -> int:
    """One tree's K5 (its package first on the path), timed at the MoE
    shapes (eager and by graph) and GIN's layer (eager); JSON on stdout."""
    sys.path.insert(0, str(pathlib.Path(args.worker) / "src"))
    import torch

    from chip_smoke import Timer
    from repro_torch.kernels.segment import kernel as k5mod
    from repro_torch.kernels.segment import segment_sum_sorted

    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    out = {"tree": args.worker, "module": k5mod.__file__}
    for shape, tokens in MOE_TOKENS.items():
        ins = moe_inputs(torch, dev, tokens)
        eo, seg, n, w, rows = ins

        def call():
            return segment_sum_sorted(eo, seg, n, weights=w, rows=rows)

        row = {"ms": timer(call, 20), "graph_ms": timer.graphed(call, 20),
               "sum": float(call().double().sum())}
        if args.library:
            row["library_ms"] = timer(moe_library(torch, ins), 20)
        out[shape] = row
        del ins, eo, rows
    h, seg, src, w, n, e = gin_inputs(torch, dev, 0, OUT / "gin.pt")
    kw = {}
    if hasattr(k5mod, "chunk_plan"):  # the caller builds the plan once
        ptr = k5mod.row_ranges(seg, n)
        kw = {"ptr": ptr, "plan": k5mod.chunk_plan(ptr, e)}
    out["gin_gather"] = {"ms": timer(lambda: segment_sum_sorted(
        h, seg, n, weights=w, rows=src, **kw), 10)}
    msgs = h.index_select(0, src)
    out["gin_contiguous"] = {"ms": timer(lambda: segment_sum_sorted(
        msgs, seg, n, **kw), 10)}
    print(json.dumps(out))
    return 0


def against_parent(args, smi, result):
    """Parent, this, this, parent: each tree's worker in its own process."""
    from chip_smoke import HBM_BYTES_PER_S

    runs = []
    for tree in (args.parent, str(ROOT), str(ROOT), args.parent):
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--worker", tree]
        if tree == str(ROOT):
            cmd.append("--library")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            raise SystemExit(f"k5_probe: the worker of {tree} failed:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result["parent"] = runs
    import torch

    bounds = {s: moe_bytes(moe_inputs(torch, torch.device("cuda"), t))
              / HBM_BYTES_PER_S * 1e3 for s, t in MOE_TOKENS.items()}
    print(f"== this tree against {args.parent}, in turns (parent, this, "
          f"this, parent) on {smi}")
    for shape in ("moe_prefill", "moe_decode", "gin_gather",
                  "gin_contiguous"):
        for key in ("ms", "graph_ms"):
            if key not in runs[0][shape]:
                continue
            par = [runs[i][shape][key] for i in (0, 3)]
            own = [runs[i][shape][key] for i in (1, 2)]
            line = (f"  {shape} {key}: parent {par[0]:.4f} / {par[1]:.4f}, "
                    f"this {own[0]:.4f} / {own[1]:.4f} ms")
            if key == "ms" and "library_ms" in runs[1][shape]:
                lib = [runs[i][shape]["library_ms"] for i in (1, 2)]
                line += f"; library {lib[0]:.4f} / {lib[1]:.4f}"
            if shape in bounds:
                line += f"; bound {bounds[shape]:.4f}"
            print(line)
        if "sum" in runs[0][shape]:
            sums = [r[shape]["sum"] for r in runs]
            print(f"  {shape}: output sums {sums} (the same inputs)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of them")
    ap.add_argument("--parent", default=None,
                    help="another tree of the repository to time against")
    ap.add_argument("--gin-nodes", type=int, default=None,
                    help="nodes of the GIN graph (default: the cell's)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    import torch

    from chip_smoke import HBM_BYTES_PER_S, REL_L1, Timer, nvidia_smi, rel_l1
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.kernels.segment import kernel as k5
    from repro_torch.kernels.segment import segment_sum_kernel

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
        for fname in ("segment_sum", "segment_sum_bf16", "segment_sum_carry"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    def use(name):
        lib = libs[name]
        k5._lib = lambda: lib
        k5.CHUNK_ROWS = variants[name][1]

    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    result = {"device": smi, "forms": {}}

    def probe(fname, fn, library, n_bytes, iters, graph):
        use("base")
        base = fn()
        for name in variants:
            use(name)
            got = fn()
            err = rel_l1(got, base)
            same = torch.equal(got, base)
            print(f"{fname} {name}: rel L1 {err:.3e} against base, "
                  f"bit-identical {same}")
            keeps = variants[name][1] == own_chunk
            if err > REL_L1 or (keeps and not same):
                raise SystemExit(f"k5_probe: {fname} {name} disagrees with "
                                 "the base build")
            del got
        fns = {name: (lambda name=name: (use(name), fn())) for name in variants}
        if library is not None:
            fns["library"] = library
            print(f"{fname}: library vs base max abs diff "
                  f"{float((library().float() - base).abs().max()):.3e}")
        del base
        times = least(timer, fns, iters)
        graphs = {}
        if graph:
            for name in variants:
                use(name)
                graphs[name] = timer.graphed(fn, 20)
        use("base")
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        result["forms"][fname] = {"bound_ms": b_ms, "times": times,
                                  "graph_ms": graphs}
        lib_ms = times.get("library", (None,))[0]
        print(f"== {fname}: bound {b_ms:.5f} ms ({n_bytes / 1e9:.4f} GB)"
              + (f"; library {lib_ms:.4f} ms [{times['library'][1]:.4f}]"
                 if lib_ms else "") + f" on {smi}")
        for name in variants:
            t, worst = times[name]
            print(f"  {name}: {t:.4f} ms [{worst:.4f}]  x{t / b_ms:.3f} "
                  "bound" + (f", x{t / lib_ms:.3f} library" if lib_ms
                             else "")
                  + (f"; by graph {graphs[name]:.5f} ms" if graph else ""),
                  flush=True)

    for shape, tokens in MOE_TOKENS.items():
        ins = moe_inputs(torch, dev, tokens)
        eo, seg, n, w, rows = ins
        print(f"{shape}: {seg.numel()} slots of D={eo.shape[1]} bf16 from "
              f"{eo.shape[0]} expert rows into {n} tokens, "
              f"{int((w == 0).sum())} dropped")
        probe(shape, lambda: segment_sum_kernel(eo, seg, n, w, rows),
              moe_library(torch, ins), moe_bytes(ins), 20, True)
        del ins, eo, rows

    t0 = time.perf_counter()
    n_real = args.gin_nodes or SHAPE_DIMS["ogb_products"]["n_real"]
    save = None
    if args.parent:  # the workers' GIN layer: this run's, made anew
        save = OUT / "gin.pt"
        save.unlink(missing_ok=True)
    h, seg, src, w, n, e = gin_inputs(torch, dev, n_real, save)
    d = h.shape[1]
    ptr = torch.searchsorted(seg, torch.arange(n + 1, dtype=seg.dtype,
                                               device=dev))
    msgs = h.index_select(0, src)
    torch.cuda.synchronize()
    print(f"GIN: N={n} E={e} d={d}: longest segment "
          f"{int(torch.diff(ptr).max())} rows; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    lengths = torch.diff(ptr)
    lo, hi = int(ptr[0]), int(ptr[-1])
    a_csr = torch.sparse_csr_tensor(ptr - lo, src[lo:hi].long(), w[lo:hi],
                                    size=(n, n))
    out_b = n * d * 4
    probe("contiguous", lambda: segment_sum_kernel(msgs, seg, n),
          lambda: torch.segment_reduce(msgs[lo:hi], "sum", lengths=lengths),
          msgs.numel() * 4 + e * 4 + out_b, 10, False)
    probe("weighted", lambda: segment_sum_kernel(msgs, seg, n, w), None,
          msgs.numel() * 4 + 2 * e * 4 + out_b, 10, False)
    del msgs
    probe("gather", lambda: segment_sum_kernel(h, seg, n, w, src),
          lambda: torch.sparse.mm(a_csr, h),
          h.numel() * 4 + 3 * e * 4 + out_b, 10, False)
    k5._lib, k5.CHUNK_ROWS = own_lib, own_chunk
    del h, seg, src, w, a_csr, ptr, lengths
    torch.cuda.empty_cache()
    if args.parent:
        against_parent(args, smi, result)
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
