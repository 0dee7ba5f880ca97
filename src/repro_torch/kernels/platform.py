"""Device resolution and the fp32 policy shared by every module of the port.

Entry points run on CUDA unless the caller asks for the CPU by name
(``device="cpu"``).  A CUDA request on a host without a card raises: the
port never drops to the CPU on its own.

TF32 is switched off at import.  The exact-distance legs use the norm
identity ``|x|^2 - 2 x.q + |q|^2``, whose cancellation TF32's 10-bit
mantissa turns into visible drift against the fp32 reference.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def on_cuda(device: torch.device | str) -> bool:
    """True when ``device`` is a CUDA device."""
    return torch.device(device).type == "cuda"


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tf32_off() -> bool:
    """True when neither matmul nor cuDNN may use TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32)
