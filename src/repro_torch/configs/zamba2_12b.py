"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + SHARED attention block [arXiv:2411.15242].

Approximation (recorded in DESIGN.md §Arch-applicability): the 38 mamba
layers are grouped into 19 segments of 2; the single shared attention+MLP
block is applied once per segment (weight re-use, as in the paper's shared
block design)."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv=32, d_ff=8192, vocab=32000, d_state=64,
        ssm_expand=2, ssm_headdim=64, ssm_per_segment=2, dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=2, n_kv=2, d_ff=128, vocab=256, d_state=16, ssm_expand=2,
        ssm_headdim=32, ssm_per_segment=2, ssm_chunk=32, dtype=torch.float32)
