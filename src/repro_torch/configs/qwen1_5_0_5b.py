"""qwen1.5-0.5b [dense] — 24L d=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
import torch

from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

ARCH_ID = "qwen1.5-0.5b"


def model_cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        dtype=torch.bfloat16,
    )


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="lm", model_cfg=cfg,
                    cells=lm_cells(cfg), source="hf:Qwen/Qwen1.5-0.5B; hf")
