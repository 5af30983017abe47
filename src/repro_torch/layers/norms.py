"""Normalisation layers with float32 statistics whatever the activation
dtype (the port of ``repro.layers.norms``: ``rms_norm`` and RWKV's
``group_norm_heads``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * weight.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the head dim (RWKV's wkv output norm); x [..., H, D],
    weight and bias [H, D] (``src/repro/layers/norms.py:25-33``). The
    variance is the population one, as ``jnp.var``'s."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * (var + eps) ** -0.5
    return (y * weight.float() + bias.float()).to(x.dtype)
