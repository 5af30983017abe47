"""RMSNorm with float32 statistics whatever the activation dtype (the port
of ``repro.layers.norms.rms_norm``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * weight.float()).to(x.dtype)
