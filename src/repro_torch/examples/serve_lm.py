"""Serve a small LM with batched requests: prefill the prompt batch, then
decode tokens for every sequence in lock-step (static KV cache; attention
on K6 on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--batch 8]
      [--prompt 64] [--gen 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import lm_token_batch
from repro_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    init_params,
    prefill_step,
)

CFG = TransformerConfig(
    name="serve-demo", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=768, vocab=4096, dtype=torch.float32, ce_chunk=64,
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, prompts: np.ndarray, gen: int):
    """Greedy decoding: the prompt batch's prefill, then ``gen - 1``
    decode steps.  Returns ``(tokens [B, gen] int64, prefill s, decode
    s)``."""
    dev = model.device
    max_seq = prompts.shape[1] + gen
    tokens_in = torch.as_tensor(prompts, device=dev)
    t0 = time.time()
    cache, logits = prefill_step(model, tokens_in, max_seq=max_seq)
    _sync(dev)
    t_prefill = time.time() - t0
    tokens = torch.argmax(logits, -1)
    generated = [tokens]
    t0 = time.time()
    for _ in range(gen - 1):
        logits, cache = decode_step(model, cache, tokens)
        tokens = torch.argmax(logits, -1)
        generated.append(tokens)
    _sync(dev)
    t_dec = time.time() - t0
    return torch.stack(generated, 1).cpu().numpy(), t_prefill, t_dec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = init_params(CFG, seed=0, device=args.device)
    prompts = lm_token_batch(0, args.batch, args.prompt, CFG.vocab)["tokens"]
    out, t_prefill, t_dec = generate(model, prompts, args.gen)
    print(f"prefill: {args.batch}x{args.prompt} tokens in "
          f"{t_prefill*1e3:.0f} ms "
          f"({args.batch * args.prompt / t_prefill:.0f} tok/s)")
    print(f"decode: {args.gen - 1} steps x {args.batch} seqs in "
          f"{t_dec*1e3:.0f} ms "
          f"({args.batch * (args.gen - 1) / max(t_dec, 1e-9):.0f} tok/s)")
    print("sample generations (token ids):")
    for row in out[:3]:
        print("  ", row[:16].tolist(), "...")
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": t_dec,
            "vocab": CFG.vocab}


if __name__ == "__main__":
    main()
