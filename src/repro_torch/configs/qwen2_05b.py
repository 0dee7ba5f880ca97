"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, GQA + QKV bias [arXiv:2407.10671]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv=2, d_ff=4864, vocab=151936, qkv_bias=True,
        dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="qwen2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, qkv_bias=True,
        dtype=torch.float32)
