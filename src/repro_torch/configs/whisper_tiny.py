"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 — enc-dec, conv frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356]."""
import torch

from repro_torch.models.transformer import LMConfig


def full(dtype=torch.bfloat16):
    return LMConfig(
        arch_id="whisper-tiny", family="encdec", n_layers=4, dec_layers=4,
        d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
        n_frames=1500, dtype=dtype, remat=True)


def smoke():
    return LMConfig(
        arch_id="whisper-smoke", family="encdec", n_layers=2, dec_layers=2,
        d_model=64, n_heads=2, n_kv=2, d_ff=128, vocab=256, n_frames=64,
        dtype=torch.float32)
