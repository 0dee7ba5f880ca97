"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="smollm-135m", family="dense", n_layers=30, d_model=576,
        n_heads=9, n_kv=3, d_ff=1536, vocab=49152, dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="smollm-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, dtype=torch.float32)
