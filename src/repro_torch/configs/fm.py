"""fm [recsys] — 39 sparse fields, embed_dim=10, 2-way FM interaction via
the O(nk) sum-square trick; 10^6 rows per field -> 39M-row fused table.
[ICDM'10 (Rendle); paper]
"""
import torch

from ..models.recsys import FMConfig
from .common import ArchSpec, ShapeCell

ARCH_ID = "fm"
I32 = torch.int32
N_CANDIDATES = 1_000_000


def model_cfg() -> FMConfig:
    return FMConfig(name=ARCH_ID, n_fields=39, vocab_per_field=1_000_000,
                    embed_dim=10)


def spec() -> ArchSpec:
    cfg = model_cfg()
    f = cfg.n_fields

    def batch_inputs(b):
        return {"ids": ((b, f), I32), "labels": ((b,), I32)}

    cells = {
        "train_batch": ShapeCell(
            name="train_batch", kind="train", inputs=batch_inputs(65_536),
            meta={"batch": 65_536}),
        "serve_p99": ShapeCell(
            name="serve_p99", kind="serve", inputs=batch_inputs(512),
            meta={"batch": 512, "note": "online-inference latency shape"}),
        "serve_bulk": ShapeCell(
            name="serve_bulk", kind="serve", inputs=batch_inputs(262_144),
            meta={"batch": 262_144, "note": "offline scoring"}),
        "retrieval_cand": ShapeCell(
            name="retrieval_cand", kind="retrieval",
            inputs={"user_ids": ((f - 1,), I32),
                    "cand_ids": ((N_CANDIDATES,), I32)},
            meta={"batch": 1, "n_candidates": N_CANDIDATES,
                  "note": "one query vs 1M candidates, single matvec"}),
    }
    return ArchSpec(arch_id=ARCH_ID, family="recsys", model_cfg=cfg,
                    cells=cells)
