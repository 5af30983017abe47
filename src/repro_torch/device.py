"""Device resolution shared by every entry point of the port.

Entry points run on ``torch.device("cuda")`` unless the caller asks for
another device (the CPU tests pass ``device="cpu"``). Without a CUDA device
and without an explicit choice they raise: the port never carries on
silently on the CPU, because the plain PyTorch path there is a reference,
not a serving path.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on (default: the current CUDA card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch reference path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
