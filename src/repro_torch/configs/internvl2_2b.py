"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend STUB (precomputed patch embeddings) +
InternLM2 backbone [arXiv:2404.16821]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv=8, d_ff=8192, vocab=92553, n_patches=256,
        dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, n_patches=16,
        dtype=torch.float32)
