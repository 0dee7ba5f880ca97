"""mamba2-130m [ssm]: 24L d_model=768 attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality) [arXiv:2405.21060]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=24, n_kv=24, d_ff=0, vocab=50280, d_state=128,
        ssm_expand=2, ssm_headdim=64, dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="mamba2-130m-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=2, n_kv=2, d_ff=0, vocab=256, d_state=16, ssm_expand=2,
        ssm_headdim=32, ssm_chunk=32, dtype=torch.float32)
