"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts (padded to 64).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .common import ArchSpec, lm_cells

ARCH_ID = "qwen2-moe-a2.7b"


def model_cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab=151936,
        qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                      n_shared=4, pad_experts_to=64),
        dtype=torch.bfloat16,
    )


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="lm", model_cfg=cfg,
                    cells=lm_cells(cfg, train_microbatches=2),
                    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf")
