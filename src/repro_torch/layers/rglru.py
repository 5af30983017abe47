"""RG-LRU recurrent block, Griffin / RecurrentGemma (the port of
``repro.layers.rglru``).

A diagonal gated linear recurrence, ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2)
* (i_t * x_t)`` with ``a_t = exp(-c * softplus(L) * r_t)``, after a width-4
causal depthwise conv. The reference scans time with
``jax.lax.associative_scan``; torch has no stable counterpart, so prefill
runs ``layers.scan.linear_scan`` (a doubling scan, 15 steps at 32,768
tokens). Decode carries a float32 {conv tail, h} state.

Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the weights are this
rank's blocks (the production layout, ``parallel.collectives``): ``wx`` and
``wgate`` column-parallel over ``rnn``, the conv, ``lam`` and the scan local
to the rank's channels. ``wa`` and ``wi`` split their input dim (``rnn``,
None): each rank's product is a partial sum over ``model`` of the whole
gate pre-activation, reduce-scattered so the rank keeps its channels
before ``ba``/``bi`` (both gates in one collective). ``wo`` row-parallel,
ending in one ``reduce_from_model``. The decode's ``conv`` and ``h`` are the
rank's channels. Without a mesh (``WHOLE``) the same body runs with
nothing split.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from .scan import linear_scan

if TYPE_CHECKING:
    from ..models.init import ParamInit

RGLRU_C = 8.0


def init_rglru(col: "ParamInit", n: int, cfg) -> dict:
    """One layer's weights (``src/repro/layers/rglru.py:18-40``); ``n`` is
    its segment's layer count (the reference's stacked dimension, which
    scales the init)."""
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "wx": col.param((d, w), "scaled", fan=n, axes=("embed", "rnn")),
        "wgate": col.param((d, w), "scaled", fan=n, axes=("embed", "rnn")),
        "conv_w": col.param((cfg.conv_width, w), "normal",
                            axes=("conv", "rnn")),
        "conv_b": col.param((w,), "zeros", axes=("rnn",)),
        "lam": col.param((w,), "ones", axes=("rnn",)),
        "wa": col.param((w, w), "scaled", fan=n, axes=("rnn", None)),
        "ba": col.param((w,), "zeros", axes=("rnn",)),
        "wi": col.param((w, w), "scaled", fan=n, axes=("rnn", None)),
        "bi": col.param((w,), "zeros", axes=("rnn",)),
        "wo": col.param((w, d), "scaled", fan=n, axes=("rnn", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; x [B,S,W], w [CW,W] -> (y, the float32 tail
    of the last CW-1 inputs) (``src/repro/layers/rglru.py:43-52``). The
    taps are summed in the reference's order, in x's dtype."""
    cw, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(cw - 1):].float()


def _rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None
                ) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t over S; x (= b) and a [B,S,W] float32,
    ``h0`` [B,W] folded into the first step
    (``src/repro/layers/rglru.py:55-69``)."""
    if h0 is not None:
        x = x.clone()
        a = a.clone()
        x[:, 0] += a[:, 0] * h0
        a[:, 0] = 0.0
    return linear_scan(a, x, dim=1)


def apply_rglru(p: dict, x: torch.Tensor, cfg, *, state=None
                ) -> tuple[torch.Tensor, dict | None]:
    """Griffin's recurrent block (``src/repro/layers/rglru.py:72-107``).
    state (decode): {"conv": [B,CW-1,W], "h": [B,W]} float32 (under a mesh,
    the rank's channels), or None (prefill); returns (y, the new state or
    None)."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    d, w, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    f32 = torch.float32
    wx, spec = lay.weight(p["wx"], ("embed", "rnn"), (d, w), dtype)
    wgate, _ = lay.weight(p["wgate"], ("embed", "rnn"), (d, w), dtype)
    tp = lay.on_model(spec, 1)
    xt = lay.copy_to_model(x) if tp else x
    u = torch.matmul(xt, wx)
    gate = F.gelu(torch.matmul(xt, wgate), approximate="tanh")
    tail = None if state is None else state["conv"]
    conv_w, _ = lay.weight(p["conv_w"], ("conv", "rnn"), (cw, w), dtype)
    conv_b, _ = lay.weight(p["conv_b"], ("rnn",), (w,), dtype)
    u, new_tail = _causal_conv(u, conv_w, conv_b, tail)

    uf = u.float()
    wa, _ = lay.weight(p["wa"], ("rnn", None), (w, w), f32)
    wi, _ = lay.weight(p["wi"], ("rnn", None), (w, w), f32)
    ba, _ = lay.weight(p["ba"], ("rnn",), (w,), f32)
    bi, _ = lay.weight(p["bi"], ("rnn",), (w,), f32)
    lam, _ = lay.weight(p["lam"], ("rnn",), (w,), f32)
    if tp:          # partial sums over model: keep this rank's channels
        ga, gi = lay.reduce_scatter_model(torch.stack(
            [torch.matmul(uf, wa), torch.matmul(uf, wi)]), -1).unbind(0)
    else:
        ga, gi = torch.matmul(uf, wa), torch.matmul(uf, wi)
    r = torch.sigmoid(ga + ba)
    i = torch.sigmoid(gi + bi)
    log_a = -RGLRU_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)

    if state is None:
        h = _rglru_scan(b, a, None)
        new_state = None
    else:
        h = a[:, 0] * state["h"] + b[:, 0]
        new_state = {"conv": new_tail, "h": h}
        h = h[:, None]

    wo, _ = lay.weight(p["wo"], ("rnn", "embed"), (w, d), dtype)
    y = torch.matmul(h.to(dtype) * gate, wo)
    return (lay.reduce_from_model(y) if tp else y), new_state
