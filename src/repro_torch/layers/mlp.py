"""Gated MLPs, SwiGLU and GeGLU (the port of ``repro.layers.mlp``)."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

if TYPE_CHECKING:
    from ..models.init import ParamInit


def init_mlp(col: ParamInit, n: int, d_model: int, d_ff: int) -> dict:
    """One layer's MLP weights; ``n`` is the layer count of its segment
    (the reference's stacked dimension, which scales the init)."""
    return {
        "wi_gate": col.param((d_model, d_ff), "scaled", fan=n,
                             axes=("embed", "mlp")),
        "wi_up": col.param((d_model, d_ff), "scaled", fan=n,
                           axes=("embed", "mlp")),
        "wo": col.param((d_ff, d_model), "scaled", fan=n,
                        axes=("mlp", "embed")),
    }


def apply_mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """x [B, S, d]; weights cast to x's dtype at each use."""
    dtype = x.dtype
    g = torch.matmul(x, p["wi_gate"].to(dtype))
    u = torch.matmul(x, p["wi_up"].to(dtype))
    h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    return torch.matmul(h, p["wo"].to(dtype))
