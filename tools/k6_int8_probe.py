#!/usr/bin/env python3
"""K6's int8 decode form beside its bf16 form, on one NVIDIA card.

    python3 tools/k6_int8_probe.py [VARIANT ...] [--against FILE ...]

Builds ``src/repro_torch/csrc/attention.cu`` as it is ("base"), once per
named variant below (source edits of its int8 dequantisation: every edit
must find its text, or the tool stops) and each ``--against`` file
(another ``attention.cu`` with the same C interface, such as a parent
commit's: ``git show HEAD~1:src/repro_torch/csrc/attention.cu >
build/parent_attention.cu``), all nvcc runs in parallel.  For each build
it counts, in the SASS of the int8 form's instance that phase 16 runs
(bf16 q, Dh 128, one query row a CTA), the instructions that convert and
round (``I2F``, ``F2F``, ``F2FP``) beside the integer and FP32 work
(``PRMT``, ``LOP3``, ``FADD``, ``FMUL``, ``FFMA``, ``IMAD``, ``SHF``) and
the copies (``LDGSTS``), by ``cuobjdump -sass``.

At the decode shapes of ``chip_smoke.py`` phase 16 (qwen2-moe-a2.7b: q
``[B, 16, 1, 128]`` bf16 over a ``[B, Smax, 16, 128]`` cache through the
model's transposed views; request A at B=8 over 2,080 keys, B at B=1 over
32,784), on random data from a seeded generator quantised by the model's
``quantize_kv``, it holds every variant but ``bare`` to the base's bits
and every build but ``bare`` to the plain version within 3e-2, and
prints the device milliseconds per call, timed by CUDA graph replay
(``chip_smoke.Timer.graphed``) over two caches in turn (the 50 MB L2
holds little of the next call's keys), the builds taken in turns (the
second round reversed; the least, the greatest in brackets), of

- the int8 form of each build with the split count forced to each of a
  few values (``split_count`` replaced for the call), its policy's value
  marked;
- the bf16 form over the dequantised cache, at its own policy's splits;
- ``scaled_dot_product_attention`` over the dequantised cache;

beside the int8 form's byte bound.  Variants: ``int_round`` (products
rounded to bf16 by integer round-to-nearest-even on the bits, not by the
packed convert), ``scalar_round`` (one ``cvt.rn.bf16.f32`` a product),
``i2f`` (each int8 made a float by the convert instruction), ``bare`` (no
conversion, scale or rounding at all: the loads, copies and the rest of
the walk alone; not the function).  With no argument, all of them.
Prints the card's name and power limit first.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import itertools
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import HBM_BYTES_PER_S, Timer, nvidia_smi  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    attention_plain, dequantize, flash_attention)
from repro_torch.kernels.attention import kernel as k6  # noqa: E402
from repro_torch.models.transformer import quantize_kv  # noqa: E402

# name: (batch, keys, forced split counts)
SHAPES = {"A": (8, 2080, (1, 2, 4)), "B": (1, 32784, (4, 8, 16, 24))}
HKV, DH = 16, 128
OUT = ROOT / "build" / "k6_int8_probe"

_MAGIC = '''  const uint32_t u = w ^ 0x80808080u;
  dst[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  dst[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  dst[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  dst[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
'''
_PACKED = '''  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
'''
_SCALE = '''    dst[e] = __fmul_rn(dst[e], scale);
    dst[e + 1] = __fmul_rn(dst[e + 1], scale);
    round_pair(dst[e], dst[e + 1], T());
'''
# name: source edits; every variant but bare (not the function) keeps the
# base's bits
VARIANTS = {
    "int_round": [(_PACKED, '''  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  a = __uint_as_float((ua + 0x7fffu + ((ua >> 16) & 1u)) & 0xffff0000u);
  b = __uint_as_float((ub + 0x7fffu + ((ub >> 16) & 1u)) & 0xffff0000u);
''')],
    "scalar_round": [(_PACKED, '''  a = __bfloat162float(__float2bfloat16_rn(a));
  b = __bfloat162float(__float2bfloat16_rn(b));
''')],
    "i2f": [(_MAGIC, '''  const char4 c = *reinterpret_cast<const char4*>(&w);
  dst[0] = c.x;
  dst[1] = c.y;
  dst[2] = c.z;
  dst[3] = c.w;
''')],
    "bare": [(_MAGIC, '''  dst[0] = dst[1] = dst[2] = dst[3] = __uint_as_float(w & 0x3f7f7f7fu);
'''), (_SCALE, "")],
}
OPCODES = ("I2F", "F2F", "F2FP", "PRMT", "LOP3", "FADD", "FMUL", "FFMA",
           "IMAD", "SHF", "LDGSTS", "LDS")


def edited_source(name, edits):
    """attention.cu with a variant's edits; stops if one misses its text."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "attention.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k6_int8_probe: {name}: no {old!r} in "
                             "attention.cu")
        src = src.replace(old, new)
    return src


def build(name, source):
    from repro_torch.kernels import _build

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "attention.cu").write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "attention.cu")],
                          capture_output=True, text=True)
    errors = [ln for ln in (proc.stdout + proc.stderr).splitlines()
              if "error" in ln]
    return name, proc.returncode, errors


def sass_counts(lib_path):
    """{opcode: count} in the SASS of the int8 form's instance at bf16 q,
    Dh 128 and one query row a CTA, or None without cuobjdump."""
    from repro_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    counts, inside = {op: 0 for op in OPCODES}, False
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            inside = ("flash_decode_kernel" in name and "Li128ELi1EaE" in name
                      and "bfloat16" in name)
            continue
        if inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          line)
            if m and m.group(1) in counts:
                counts[m.group(1)] += 1
    return counts


def graphed(fns, iters=40):
    """Mean device ms per call of ``fns`` taken in turn, by graph replay."""
    calls = itertools.cycle(fns)
    return Timer(torch, torch.device("cuda")).graphed(
        lambda: next(calls)(), iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="default: all of them")
    ap.add_argument("--against", nargs="*", default=[],
                    help="other attention.cu files with the same C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_int8_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    wanted = args.variants or list(VARIANTS)
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        print(f"k6_int8_probe: no variant {sorted(unknown)}; there are "
              f"{sorted(VARIANTS)}", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    sources = {"base": edited_source("base", []),
               **{n: edited_source(n, VARIANTS[n]) for n in wanted},
               **{f"against{i}": pathlib.Path(f).read_text()
                  for i, f in enumerate(args.against)}}
    for i, f in enumerate(args.against):
        print(f"against{i}: {f}")
    with cf.ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda n: build(n, sources[n]), sources))
    for name, rc, errors in built:
        print(f"{name}: nvcc exit {rc}" + "".join(f"\n  {e}" for e in errors))
    if any(rc for _, rc, _ in built):
        return 1
    for name in sources:
        print(f"{name}: SASS of the int8 form (bf16, Dh 128, 1 row a CTA): "
              f"{sass_counts(OUT / name / 'lib.so')}")

    own_lib = k6._lib
    real = own_lib()
    libs = {}
    for name in sources:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fname in ("flash_attention", "flash_attention_int8",
                      "flash_decode_geometry", "flash_prefill_route"):
            getattr(lib, fname).argtypes = getattr(real, fname).argtypes
            getattr(lib, fname).restype = getattr(real, fname).restype
        libs[name] = lib

    def use(name):
        k6._lib = lambda: libs[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    policy = k6.split_count
    for shape, (b, sk, splits) in SHAPES.items():
        sets = []
        for _ in range(2):
            c8, sc = quantize_kv(torch.randn((2, b, sk, HKV, DH), generator=gen,
                                             device=dev).bfloat16())
            q = (torch.randn((b, 1, HKV, DH), generator=gen, device=dev)
                 * 0.2).bfloat16().transpose(1, 2)
            k, v = c8[0].transpose(1, 2), c8[1].transpose(1, 2)
            ks, vs = sc[0].transpose(1, 2), sc[1].transpose(1, 2)
            sets.append((q, k, v, ks, vs, dequantize(k, ks, q.dtype),
                         dequantize(v, vs, q.dtype)))
        q, k, v, ks, vs, kd, vd = sets[0]

        def int8(s):
            return flash_attention(s[0], s[1], s[2], causal=False,
                                   k_scale=s[3], v_scale=s[4])

        use("base")
        got = int8(sets[0])
        err = float((got.float() - attention_plain(
            q, k, v, causal=False, k_scale=ks, v_scale=vs).float()).abs().max())
        same = torch.equal(got, flash_attention(q, kd, vd, causal=False))
        n_bytes = 2 * b * HKV * sk * (DH + 4) + 2 * q.numel() * 2
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        own = policy(b, HKV, HKV, 1, sk, n_sm,
                     k6.decode_geometry(torch.bfloat16, DH, True))
        print(f"{shape}: q {tuple(q.shape)} over int8 {tuple(k.shape)}: max "
              f"abs err {err:.3e} against the plain version, the bits of the "
              f"bf16 form over the dequantised cache {same}; byte bound "
              f"{b_ms:.4f} ms")
        plain = attention_plain(q, k, v, causal=False, k_scale=ks,
                                v_scale=vs).float()
        for name in sources:
            use(name)
            mine = int8(sets[0])
            bits = torch.equal(mine, got)
            e_n = float((mine.float() - plain).abs().max())
            print(f"  {name}: the base build's bits {bits}, max abs err "
                  f"{e_n:.3e} against the plain version")
            if name == "bare":
                continue
            if (not bits and name in VARIANTS) or (
                    e_n > 3e-2):
                raise SystemExit(f"k6_int8_probe: {name} disagrees at "
                                 f"{shape}")
        for n in sorted(set(splits) | {own}):
            k6.split_count = lambda *a, n=n: n
            got_ms = {name: [] for name in sources}
            try:
                for order in (list(sources), list(sources)[::-1]):
                    for name in order:
                        use(name)
                        got_ms[name].append(graphed(
                            [lambda s=s: int8(s) for s in sets]))
            finally:
                k6.split_count = policy
                use("base")
            print(f"  {n} split(s){' (policy)' if n == own else ''}: " + ", ".join(
                f"{name} {min(t):.5f} [{max(t):.5f}]"
                for name, t in got_ms.items()) + " ms", flush=True)
        bf16 = graphed([lambda s=s: flash_attention(s[0], s[5], s[6],
                                                    causal=False)
                        for s in sets])
        lib = graphed([lambda s=s: torch.nn.functional.scaled_dot_product_attention(
            s[0], s[5], s[6]) for s in sets])
        print(f"  bf16 form over the dequantised cache: {bf16:.5f} ms; "
              f"scaled_dot_product_attention over it: {lib:.5f} ms; bound "
              f"{b_ms:.5f} ms; on {smi}")
    k6._lib = own_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
