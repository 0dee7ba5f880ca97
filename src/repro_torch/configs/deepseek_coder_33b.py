"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch [arXiv:2401.14196]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="deepseek-coder-33b", family="dense", n_layers=62,
        d_model=7168, n_heads=56, n_kv=8, d_ff=19200, vocab=32256,
        dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="deepseek-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, dtype=torch.float32)
