"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU. Asking for CUDA where there is none raises:
    the serve path never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
