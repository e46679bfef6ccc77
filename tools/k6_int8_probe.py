#!/usr/bin/env python3
"""K6's int8 decode form beside its bf16 form, on one NVIDIA card.

    python3 tools/k6_int8_probe.py

At the decode shapes of ``chip_smoke.py`` phase 16 (qwen2-moe-a2.7b: q
``[B, 16, 1, 128]`` bf16 over a ``[B, Smax, 16, 128]`` cache through the
model's transposed views; request A at B=8 over 2,080 keys, B at B=1 over
32,784), on random data from a seeded generator quantised by the model's
``quantize_kv``, it prints the device milliseconds per call, timed by
CUDA graph replay (``chip_smoke.Timer.graphed``) over two caches in turn
(the 50 MB L2 holds little of the next call's keys), of

- the int8 form with the split count forced to each of a few values
  (``split_count`` replaced for the call), its policy's value marked;
- the bf16 form over the dequantised cache, at its own policy's splits;
- ``scaled_dot_product_attention`` over the dequantised cache;

beside the int8 form's byte bound.  Prints the card's name and power limit
first.  Exits non-zero without a card.
"""
from __future__ import annotations

import itertools
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import HBM_BYTES_PER_S, Timer  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    attention_plain, dequantize, flash_attention)
from repro_torch.kernels.attention import kernel as k6  # noqa: E402
from repro_torch.models.transformer import quantize_kv  # noqa: E402

# name: (batch, keys, forced split counts)
SHAPES = {"A": (8, 2080, (1, 2, 4)), "B": (1, 32784, (4, 8, 16, 24))}
HKV, DH = 16, 128


def graphed(fns, iters=40):
    """Mean device ms per call of ``fns`` taken in turn, by graph replay."""
    calls = itertools.cycle(fns)
    return Timer(torch, torch.device("cuda")).graphed(
        lambda: next(calls)(), iters)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_int8_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    policy = k6.split_count
    for name, (b, sk, splits) in SHAPES.items():
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
        got = flash_attention(q, k, v, causal=False, k_scale=ks, v_scale=vs)
        err = float((got.float() - attention_plain(
            q, k, v, causal=False, k_scale=ks, v_scale=vs).float()).abs().max())
        same = torch.equal(got, flash_attention(q, kd, vd, causal=False))
        n_bytes = 2 * b * HKV * sk * (DH + 4) + 2 * q.numel() * 2
        own = policy(b, HKV, HKV, 1, sk, n_sm,
                     k6.decode_geometry(torch.bfloat16, DH, True))
        print(f"{name}: q {tuple(q.shape)} over int8 {tuple(k.shape)}: max abs "
              f"err {err:.3e} against the plain version, the bits of the "
              f"bf16 form over the dequantised cache {same}; byte bound "
              f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        for n in sorted(set(splits) | {own}):
            k6.split_count = lambda *a, n=n: n
            try:
                ms = graphed([lambda s=s: flash_attention(
                    s[0], s[1], s[2], causal=False, k_scale=s[3],
                    v_scale=s[4]) for s in sets])
            finally:
                k6.split_count = policy
            print(f"  int8 form, {n} split(s){' (policy)' if n == own else ''}"
                  f": {ms:.5f} ms")
        bf16 = graphed([lambda s=s: flash_attention(s[0], s[5], s[6],
                                                    causal=False)
                        for s in sets])
        lib = graphed([lambda s=s: torch.nn.functional.scaled_dot_product_attention(
            s[0], s[5], s[6]) for s in sets])
        print(f"  bf16 form over the dequantised cache: {bf16:.5f} ms; "
              f"scaled_dot_product_attention over it: {lib:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
