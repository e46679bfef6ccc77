#!/usr/bin/env python3
"""Where K6's wgmma prefill kernel spends its time, by ablation, on one
NVIDIA card.

    python3 tools/k6_prefill_probe.py [VARIANT ...]

Builds ``src/repro_torch/csrc/attention.cu`` once as it is ("base") and
once per named variant below, each a list of source edits (every edit
must find its text, or the tool stops), all nvcc runs in parallel; prints
what ptxas says of each build's wgmma kernels (serialised wgmma, spills,
registers); loads each build in turn in place of the wrapper's library and

- holds it to ``attention_plain`` at three small bf16 shapes (an ablation
  that drops work computes garbage: its error is printed, not checked);
- times it (CUDA events, eager, as ``chip_smoke.py`` does; the least of
  two rounds, the second in reverse order, the greatest in brackets) at
  phase 12's prefill layers A (8 x 2,048) and B (1 x 32,768) of
  qwen1.5-0.5b and at a Dh 128 GQA layer (1 x 8,192, 32 q heads over 8 kv
  heads), all causal, beside ``scaled_dot_product_attention``.

Variants: ``no_exp2`` (the softmax's ex2 replaced by a copy: no MUFU
work), ``no_wgmma`` (no tensor-core products: the loads, the softmax and
the turn-taking alone), ``bare`` (neither), ``two_consumers`` (Dh 64 on
128-row blocks of two consumers, not 192 of three), ``stages2`` (two K/V
stages, not three), ``all_tiles`` (every consumer computes every tile
of its block: none skipped past seq_q or above its causal diagonal).
With no argument, all of them.  Prints the card's name and power limit
first; exits non-zero without a card.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_NO_EXP2 = [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
             "y = x;")]
_NO_WGMMA = [
    ("wgmma_ss_n128(s, dq + (((ks >> 2) * G::kQPanel + in_panel) >> 4),\n"
     "                      dk + (((ks >> 2) * G::kPanel + in_panel) >> 4),"
     " ks > 0);", "(void)in_panel;"),
    ("wgmma_pv<DH>(acc, a, dv + ((kk * 16 * 128) >> 4));", "(void)a;")]
VARIANTS = {
    "no_exp2": _NO_EXP2,
    "no_wgmma": _NO_WGMMA,
    "bare": _NO_EXP2 + _NO_WGMMA,
    "two_consumers": [("kConsumers = DH == 64 ? 3 : 2", "kConsumers = 2")],
    "stages2": [("kStages = 3;", "kStages = 2;")],
    "all_tiles": [("    const int n_live = last_row < q0 + 64 * c ? 0\n"
                   "                       : causal                ? "
                   "min(n_tiles, last_row / G::kKeys + 1)\n"
                   "                                               : n_tiles;",
                   "    const int n_live = n_tiles;\n    (void)last_row;")],
}
# (batch, q heads, kv heads, tokens, Dh, causal)
CHECKS = [(2, 8, 2, 1000, 64, True), (2, 8, 2, 1000, 128, True),
          (2, 4, 4, 300, 64, False)]
# name: (batch, q heads, kv heads, tokens, Dh, timed calls)
LAYERS = {"A": (8, 16, 16, 2048, 64, 20), "B": (1, 16, 16, 32768, 64, 3),
          "Dh128": (1, 32, 8, 8192, 128, 10)}
OUT = ROOT / "build" / "k6_prefill_probe"


def build(name, edits):
    from repro_torch.kernels import _build

    src = (_build.CSRC / "attention.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k6_prefill_probe: {name}: no {old!r} in "
                             "attention.cu")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "attention.cu").write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "attention.cu")],
                          capture_output=True, text=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    info = [ln.strip() for ln in lines if "C75" in ln or "error" in ln]
    for i, ln in enumerate(lines):
        if "Function properties" in ln and "prefill_wgmma" in ln:
            dh = "Dh 128" if "ILi128" in ln else "Dh 64"
            info.append(f"{dh}: {lines[i + 1].strip()}; "
                        f"{lines[i + 2].strip()[len('ptxas info    : '):]}")
    return name, proc.returncode, info


def load(name):
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as fn

    from chip_smoke import Timer, nvidia_smi
    from repro_torch.kernels.attention import (
        attention_plain, flash_attention, kernel as k6)

    if not torch.cuda.is_available():
        print("k6_prefill_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    wanted = sys.argv[1:] or list(VARIANTS)
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        print(f"k6_prefill_probe: no variant {sorted(unknown)}; there are "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    edits = {"base": [], **{n: VARIANTS[n] for n in wanted}}
    with cf.ThreadPoolExecutor(len(edits)) as ex:
        built = list(ex.map(lambda n: build(n, edits[n]), edits))
    for name, rc, info in built:
        print(f"{name}: nvcc exit {rc}\n  " + "\n  ".join(info))
    if any(rc for _, rc, _ in built):
        return 1
    own_lib = k6._lib  # the wrapper's loader of the unmodified library
    libs = {name: load(name) for name in edits}

    def typed(lib):  # the argtypes the wrapper gives its own library
        if lib.flash_attention.argtypes is None:
            real = own_lib()
            for fname in ("flash_attention", "flash_decode_geometry",
                          "flash_prefill_route"):
                getattr(lib, fname).argtypes = getattr(real, fname).argtypes
                getattr(lib, fname).restype = getattr(real, fname).restype
        return lib

    def use(name):
        k6._lib = lambda: typed(libs[name])

    gen = torch.Generator(device="cuda")

    def inputs(b, hq, hkv, s, dh, seed):
        gen.manual_seed(seed)

        def make(h, scale):  # the model's [B, S, H, Dh] layout, transposed
            return (torch.randn((b, s, h, dh), generator=gen, device="cuda")
                    * scale).bfloat16().transpose(1, 2)

        return make(hq, 0.5), make(hkv, 0.5), make(hkv, 1.0)

    for name in edits:
        use(name)
        errs = []
        for i, (b, hq, hkv, s, dh, causal) in enumerate(CHECKS):
            q, k, v = inputs(b, hq, hkv, s, dh, i)
            out = flash_attention(q, k, v, causal=causal)
            want = attention_plain(q, k, v, causal=causal)
            errs.append(float((out.float() - want.float()).abs().max()))
        print(f"{name}: max abs err against the plain version "
              + ", ".join(f"{e:.3e}" for e in errs), flush=True)
    timer = Timer(torch, torch.device("cuda"))
    data = {key: inputs(*shape[:5], 7) for key, shape in LAYERS.items()}
    times = {name: {key: [] for key in LAYERS} for name in edits}
    for order in (list(edits), list(edits)[::-1]):
        for name in order:
            use(name)
            for key, (*_, iters) in LAYERS.items():
                q, k, v = data[key]
                times[name][key].append(timer(
                    lambda: flash_attention(q, k, v, causal=True), iters))
    k6._lib = own_lib
    lib_ms = {}
    for key, (b, hq, hkv, s, dh, iters) in LAYERS.items():
        q, k, v = data[key]
        kr, vr = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
        lib_ms[key] = timer(lambda: fn.scaled_dot_product_attention(
            q, kr, vr, is_causal=True), iters)
    print("ms per call, causal; library " + ", ".join(
        f"{key} {ms:.4f}" for key, ms in lib_ms.items()))
    for name in edits:
        print(f"{name:14s} " + ", ".join(
            f"{key} {min(t):.4f} ({max(t):.4f})"
            for key, t in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
