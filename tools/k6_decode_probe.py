#!/usr/bin/env python3
"""Where K6's decode kernel spends its time, on one NVIDIA card.

    python3 tools/k6_decode_probe.py

At the decode shapes of ``chip_smoke.py`` phase 12 (qwen1.5-0.5b: q
``[B, 16, 1, 64]`` bf16 over a ``[B, Smax, 16, 64]`` cache through the
model's transposed views; request A at B=8 over 2,080 keys, B at B=1 over
32,784), with random data from a seeded generator, it prints the device
milliseconds per call of K6 and of ``scaled_dot_product_attention``, timed
by CUDA graph replay (``chip_smoke.Timer.graphed``: no host gaps):

- warm (one cache, re-read every call, as ``chip_smoke.py`` times it) and
  cold (four caches in turn, 4 x 68 MB for A and 2 x 134 MB for B: the
  50 MB L2 holds none of the next call's keys, as in a decode step);
- K6 with the split count forced to each of a few values (``split_count``
  replaced for the call), its own policy's value marked;
- K6 at ``kv_len`` 1, where the launch, the first tile's latency and, with
  splits, the arrival atomic and the combine are all there is.

Prints the card's name and power limit first.  Exits non-zero without a
card.
"""
from __future__ import annotations

import itertools
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import Timer  # noqa: E402
from repro_torch.kernels.attention import attention_plain, flash_attention  # noqa: E402
from repro_torch.kernels.attention import kernel as k6  # noqa: E402

SHAPES = {"A": (8, 2080, 4, (1, 2, 4)), "B": (1, 32784, 2, (4, 8, 16, 24))}


def graphed(fns, iters=40):
    """Mean device ms per call of ``fns`` taken in turn, by graph replay."""
    calls = itertools.cycle(fns)
    return Timer(torch, torch.device("cuda")).graphed(
        lambda: next(calls)(), iters)


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_decode_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    policy = k6.split_count
    for name, (b, smax, n_caches, splits) in SHAPES.items():
        sets = []
        for _ in range(n_caches):
            cache = torch.randn((2, b, smax, 16, 64), generator=gen,
                                device=dev).bfloat16()
            q = (torch.randn((b, 1, 16, 64), generator=gen, device=dev)
                 * 0.2).bfloat16().transpose(1, 2)
            sets.append((q, cache[0].transpose(1, 2), cache[1].transpose(1, 2)))

        def k6_calls(kv, sets):
            return [lambda s=s: flash_attention(s[0], s[1], s[2], causal=False,
                                                kv_len=kv) for s in sets]

        def lib_calls(sets):
            return [lambda s=s: torch.nn.functional.scaled_dot_product_attention(
                s[0], s[1], s[2]) for s in sets]

        q, k, v = sets[0]
        err = float((flash_attention(q, k, v, causal=False, kv_len=smax).float()
                     - attention_plain(q, k, v, causal=False,
                                       kv_len=smax).float()).abs().max())
        bound = 2 * b * 16 * smax * 64 * 2 / 3.35e12 * 1e3
        own = policy(b, 16, 16, 1, smax, n_sm,
                     k6.decode_geometry(torch.bfloat16, 64))
        print(f"{name}: [{b}, 16, 1, 64] over {smax} keys, bound {bound:.4f} ms"
              f", K6 max abs err {err:.3e}, policy {own} split(s)")
        print(f"  library: warm {graphed(lib_calls(sets[:1])):.4f} cold "
              f"{graphed(lib_calls(sets)):.4f}")
        for n in sorted(set(splits) | {own}):
            k6.split_count = lambda *a, n=n: n
            try:
                print(f"  K6 {n:2d} split(s){' (policy)' if n == own else ''}:"
                      f" warm {graphed(k6_calls(smax, sets[:1])):.4f} cold "
                      f"{graphed(k6_calls(smax, sets)):.4f} kv_len 1 "
                      f"{graphed(k6_calls(1, sets[:1])):.4f}")
            finally:
                k6.split_count = policy
        del sets, q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
