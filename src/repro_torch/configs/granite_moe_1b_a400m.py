"""granite-moe-1b-a400m [moe] — 24L d=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8, no shared experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .common import ArchSpec, lm_cells

ARCH_ID = "granite-moe-1b-a400m"


def model_cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,
        vocab=49155,
        qkv_bias=False,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, n_shared=0),
        dtype=torch.bfloat16,
    )


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="lm", model_cfg=cfg,
                    cells=lm_cells(cfg, train_microbatches=1),
                    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")
