"""Serving CLI, ``lm`` mode: batched prefill + greedy decode.

The port of ``repro.launch.serve``'s ``lm`` mode, through
:mod:`repro_torch.launch.steps` (the ``prefill_32k`` / ``decode_32k``
cells' step kinds), with ``--device`` (default ``cuda``: it serves on the
card unless the CPU is asked for).  The model is the reduced config of
``configs.smoke.lm_shrink`` (float32, 2 layers), as in the reference;
weights come from a seeded generator (no checkpoint is read).  The
``rank`` mode waits with batched serving (ROADMAP §1, item 4).

  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen1.5-0.5b \
      --device cpu --gen 8
"""
import argparse
import sys
import time

import numpy as np


def lm_main(argv):
    import torch

    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer as lm

    ap = argparse.ArgumentParser(prog="serve [lm]")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda | cpu)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        ap.error(f"{args.arch} is a {spec.family} arch: serving applies to "
                 "the LM archs")
    if args.gen < 1:
        ap.error("--gen must be at least 1")
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = lm_shrink(spec.model_cfg)
    model = lm.init_params(cfg, seed=0, device=args.device)
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)
    prompts = lm_token_batch(0, args.batch, args.prompt, cfg.vocab)["tokens"]

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cache, logits = prefill({"tokens": prompts,
                             "max_seq": args.prompt + args.gen})
    sync()
    print(f"[{args.arch}] prefill {args.batch}x{args.prompt}: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    toks = logits.argmax(-1)
    outs = [toks]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode({"tokens": toks, "cache_k": cache["k"],
                                "cache_v": cache["v"], "pos": cache["pos"]})
        toks = logits.argmax(-1)
        outs.append(toks)
    sync()
    dt = time.perf_counter() - t0
    print(f"decode {args.gen - 1} steps: {dt * 1e3:.1f} ms "
          f"({args.batch * (args.gen - 1) / max(dt, 1e-9):.0f} tok/s)")
    print("generated ids:",
          np.stack([t.cpu().numpy() for t in outs], 1)[0][:12].tolist())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "rank":
        raise SystemExit("serve rank is not ported yet (ROADMAP §1, item 4)")
    if argv and argv[0] == "lm":
        argv = argv[1:]
    return lm_main(argv)


if __name__ == "__main__":
    main()
