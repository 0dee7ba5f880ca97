"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752,
vocab=100352, MoE 16 experts top-4 (fine-grained) [hf:databricks/dbrx-base]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv=8, d_ff=10752, vocab=100352, n_experts=16, top_k=4,
        dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="dbrx-smoke", family="moe", n_layers=2, d_model=96,
        n_heads=6, n_kv=2, d_ff=160, vocab=256, n_experts=4, top_k=2,
        dtype=torch.float32)


def full_cf1(dtype=None):
    """Hillclimb cell B, iteration 3: capacity factor 1.0 for inference
    (balanced routing drops ~nothing; -20% expert FLOPs)."""
    import dataclasses
    cfg = full(dtype or torch.bfloat16)
    return dataclasses.replace(cfg, arch_id="dbrx-132b-cf1",
                               capacity_factor=1.0)
