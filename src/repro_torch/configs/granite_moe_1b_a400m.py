"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="granite-moe-1b-a400m", family="moe", n_layers=24,
        d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
        n_experts=32, top_k=8, dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=96, vocab=256, n_experts=4, top_k=2,
        dtype=torch.float32)
