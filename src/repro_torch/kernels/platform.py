"""Device resolution and the fp32 policy shared by every module of the port.

Entry points run on CUDA unless the caller asks for the CPU by name
(``device="cpu"``).  A CUDA request on a host without a card raises: the
port never drops to the CPU on its own.

TF32 is switched off at import, so that any fp32 matrix product left in
the port (the RaBitQ encoder's rotation, k-means, exact ground truth)
stays fp32 as in the reference; TF32's 10-bit mantissa would drift off it.
The exact-distance legs of the kernels and their plain versions sum
``(x - q)^2`` directly and use no matrix product.
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
