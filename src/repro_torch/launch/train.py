"""Training driver (the port of ``repro.launch.train``): ``--arch <id>``
selects an LM architecture, whose reduced configuration
(``configs.smoke.smoke_setup``: 2 layers, d=64, float32) trains through
the fault-tolerant runtime (batches made from the step -> AdamW ->
checkpoints every 25 steps -> auto-resume) on the card, or on the CPU
with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50 --device cpu

It prints the reduced config's parameter count, the loss every 10 steps
and the first and last loss, as the reference's driver does.  The
checkpoints go to ``--ckpt`` (default ``build/train_ckpt/<arch>`` in the
checkout); a directory that holds one resumes from its newest step, a
reference checkpoint of the same model included.  The GNN and recsys
archs' training waits (ROADMAP §1, item 7 (b)).
"""
from __future__ import annotations

import argparse
import pathlib

import torch

_ROOT = pathlib.Path(__file__).resolve().parents[3]


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.smoke import smoke_setup
    from repro_torch.data import lm_token_batch
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models import transformer as lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    ap = argparse.ArgumentParser(prog="train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda | cpu)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    cfg, _, family = smoke_setup(args.arch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    model = lm.init_params(cfg, seed=0, device=args.device)
    step_fn = lm_train_step(model, ocfg)

    def init_state():
        params = model.param_tree()
        n = sum(p.numel() for p in model.parameters())
        print(f"[{args.arch}] reduced config: {n/1e6:.2f}M params "
              f"(family={family})")
        return params, adamw_init(params)

    def make_batch(step):
        return lm_token_batch(step, 2, 32, cfg.vocab)

    ckpt = args.ckpt or str(_ROOT / "build" / "train_ckpt"
                            / args.arch.replace(".", "_"))
    loop = TrainLoop(step_fn, make_batch, init_state,
                     TrainLoopConfig(total_steps=args.steps, ckpt_dir=ckpt,
                                     ckpt_every=25, log_every=10))
    out = loop.run(verbose=True)
    losses = [m["loss"] for m in out["metrics"]]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps")


if __name__ == "__main__":
    main()
