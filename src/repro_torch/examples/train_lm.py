"""Train a transformer LM end-to-end with the full runtime substrate:
deterministic data pipeline, AdamW with fp32 master weights, atomic async
checkpoints, auto-resume, straggler monitor.

Default is a ~14M-param model that trains a few hundred steps;
``--width 512 --layers 12`` gives the ~100M-param configuration (same code
path).  Checkpoints go to ``--ckpt`` (default ``build/examples/lm_ckpt``
under the working directory); a re-run resumes from the newest.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.data import lm_token_batch
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    init_params,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import TrainLoop, TrainLoopConfig


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt", default="build/examples/lm_ckpt")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def config(args) -> TransformerConfig:
    return TransformerConfig(
        name="example-lm",
        n_layers=args.layers,
        d_model=args.width,
        n_heads=max(2, args.width // 64),
        n_kv_heads=max(1, args.width // 128),
        d_ff=args.width * 3,
        vocab=args.vocab,
        dtype=torch.float32,
        ce_chunk=args.seq,
    )


def run(args, model: Optional[Transformer] = None) -> dict:
    """The training loop; ``model`` (default: seeded ``init_params``)
    holds the initial weights."""
    cfg = config(args)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    if model is None:
        model = init_params(cfg, seed=0, device=args.device)
    step_fn = lm_train_step(model, ocfg, cfg)

    def init_state():
        p = model.param_tree()
        n = sum(x.numel() for x in tree_leaves(p))
        print(f"model: {n/1e6:.1f}M params")
        return p, adamw_init(p)

    def make_batch(step):
        return lm_token_batch(step, args.batch, args.seq, args.vocab)

    loop = TrainLoop(
        step_fn, make_batch, init_state,
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=50, log_every=10),
    )
    out = loop.run(verbose=True)
    losses = [m["loss"] for m in out["metrics"]]
    first = losses[0] if losses else float("nan")
    last = losses[-1] if losses else float("nan")
    print(f"done: loss {first:.3f} -> {last:.3f} "
          f"({out['mean_step_time']*1e3:.0f} ms/step); "
          f"checkpoints in {args.ckpt} (re-run resumes automatically)")
    return {"losses": losses, "steps": [m["step"] for m in out["metrics"]],
            "mean_step_time": out["mean_step_time"], "ckpt": args.ckpt}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
