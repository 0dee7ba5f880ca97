"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-32B family]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv=40, d_ff=27392, vocab=152064, qkv_bias=True,
        dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="qwen15-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256, qkv_bias=True,
        dtype=torch.float32)


def full_padded_heads(dtype=None):
    """Hillclimb variant (EXPERIMENTS.md §Perf cell A): q/kv heads padded
    40 -> 48 so heads divide the 16-way model axis.  Mathematically exact
    when the 8 extra heads' wo rows are zero; +20% attention FLOPs traded
    for shard-local decode attention (no cache all-gathers)."""
    import dataclasses
    cfg = full(dtype or torch.bfloat16)
    return dataclasses.replace(cfg, arch_id="qwen1.5-32b-pad48",
                               n_heads=48, n_kv=48, head_dim=128)


def full_padded_kvq(dtype=None):
    """Hillclimb cell A, iteration 2: padded heads + int8 KV cache."""
    import dataclasses
    cfg = full_padded_heads(dtype)
    return dataclasses.replace(cfg, arch_id="qwen1.5-32b-pad48-kvq",
                               kv_quant=True)
