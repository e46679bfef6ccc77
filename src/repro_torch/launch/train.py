"""Training driver (the port of ``repro.launch.train``): ``--arch <id>``
selects an architecture, whose reduced configuration
(``configs.smoke.smoke_setup``: an LM at 2 layers, d=64; a GNN (GIN,
MeshGraphNet, EGNN, DimeNet) at 3 layers, d=16, on batched small graphs;
FM at 6 fields of 100 rows, D=8; all float32) trains through the
fault-tolerant runtime (batches made from the step -> AdamW ->
checkpoints every 25 steps -> auto-resume) on the card, or on the CPU
with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dimenet --device cpu

It prints the reduced config's parameter count, the loss every 10 steps
and the first and last loss, as the reference's CLI does.  The batch
of a step is the reference's: ``lm_token_batch(step, 2, 32, vocab)``,
``criteo_like_batch(step, 32, ...)``, or a GNN's one fixed graph batch
(sorted once, ``gnn.prepare_batch``).
The checkpoints go to ``--ckpt`` (default ``build/train_ckpt/<arch>`` in
the checkout); a directory that holds one resumes from its newest step,
a reference checkpoint of the same model included.  The reference's
archs still to port are accepted and raise, naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import pathlib

import torch

_ROOT = pathlib.Path(__file__).resolve().parents[3]


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS, PENDING
    from repro_torch.configs.smoke import smoke_setup
    from repro_torch.data import criteo_like_batch, lm_token_batch
    from repro_torch.launch.steps import (fm_train_step, gnn_train_step,
                                          lm_train_step)
    from repro_torch.models import gnn, recsys
    from repro_torch.models import transformer as lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    ap = argparse.ArgumentParser(prog="train")
    ap.add_argument("--arch", required=True,
                    choices=ARCH_IDS + list(PENDING))
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
    cfg, batch0, family = smoke_setup(args.arch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    if family == "lm":
        model = lm.init_params(cfg, seed=0, device=args.device)
        step_fn = lm_train_step(model, ocfg)

        def make_batch(step):
            return lm_token_batch(step, 2, 32, cfg.vocab)
    elif family == "recsys":
        model = recsys.FM(cfg, seed=0, device=args.device)
        step_fn = fm_train_step(model, ocfg)

        def make_batch(step):
            return criteo_like_batch(step, 32, cfg.n_fields,
                                     cfg.vocab_per_field)
    else:
        model = gnn.init_params(cfg, seed=0, device=args.device)
        step_fn = gnn_train_step(model, ocfg)
        fixed = gnn.prepare_batch(batch0, args.device, cfg.arch)

        def make_batch(step):  # GNN: the fixed full-batch graph
            return fixed

    def init_state():
        params = model.param_tree()
        n = sum(p.numel() for p in model.parameters())
        print(f"[{args.arch}] reduced config: {n/1e6:.2f}M params "
              f"(family={family})")
        return params, adamw_init(params)

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
