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


def apply_mlp(p: dict, x: torch.Tensor, act: str = "swiglu",
              d_ff: int | None = None, *, partial: bool = False):
    """x [B, S, d]; weights cast to x's dtype at each use.

    Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the weights are
    this rank's blocks of a ``[d, d_ff]`` MLP (``d_ff`` required): gathered
    over FSDP's dims at use, and, where the rules split ``mlp`` over
    ``model``, column-parallel up and gate and a row-parallel down, ended
    by one ``reduce_from_model``. ``partial=True`` leaves that sum to the
    caller and returns ``(y, whether y is a partial sum over model)``."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    d = x.shape[-1]
    wg, spec = lay.weight(p["wi_gate"], ("embed", "mlp"), (d, d_ff), dtype)
    wu, _ = lay.weight(p["wi_up"], ("embed", "mlp"), (d, d_ff), dtype)
    wo, _ = lay.weight(p["wo"], ("mlp", "embed"), (d_ff, d), dtype)
    tp = lay.on_model(spec, 1)
    xt = lay.copy_to_model(x) if tp else x
    g = torch.matmul(xt, wg)
    u = torch.matmul(xt, wu)
    h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    y = torch.matmul(h, wo)
    if partial:
        return y, tp
    return lay.reduce_from_model(y) if tp else y
