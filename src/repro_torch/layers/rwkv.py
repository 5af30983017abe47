"""RWKV6 "Finch": token shift and the data-dependent-decay WKV recurrence
(the port of ``repro.layers.rwkv``).

As in the reference, prefill runs the *chunked* form of the linear
recurrence: chunks of ``CHUNK`` positions, per-channel log-decays clamped
at ``LOGW_MIN`` a step so that every chunk-local ``exp(±cum)`` factor
(up to e^64) stays inside float32's range, the strictly-lower mask applied
as a multiplication. The reference scans the chunks one after the other
(``src/repro/layers/rwkv.py:107``): at 32,768 tokens that is 2,048 chunk
bodies a layer, which a Python loop would launch one by one. Here every
chunk-local term is computed for all chunks at once (``[B, N, C, H, D]``),
only the chunk-to-chunk state recurrence ``state_n = state_{n-1} * dec_n +
sum_c k_end (x) v`` runs, as ``layers.scan.linear_scan`` (log depth), and
each chunk's inter-chunk output is formed from the state before it. The
same function; only the float32 summation order differs. Decode runs the
exact one-step recurrence with a float32 state (``shift`` [B, d], ``wkv``
[B, H, D, D]) cast to the activation dtype at use.

Token-shift mixing is the reference's static per-channel lerp (its noted
simplification of RWKV6's dynamic ddlerp).

Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the weights are this
rank's blocks (the production layout, ``parallel.collectives``). Time mix:
``wr``/``wk``/``wv``/``wg`` column-parallel over the heads, ``u``, the group
norm and the WKV local to the rank's heads; the decay, whose ``w0`` and
lora carry no head axis, is computed whole on every rank and narrowed to
the rank's channels (``slice_replicated``); ``wo`` row-parallel, ending in
one ``reduce_from_model``; the decode's ``wkv`` state is the rank's heads,
``shift`` whole. Channel mix: ``wk`` column-parallel over ``mlp`` and ``wv``
row-parallel (``vv`` whole after the reduce), ``wr`` column-parallel over
the heads, its block of ``rr`` gathered over ``model`` before the product.
Without a mesh (``WHOLE``) the same body runs with nothing split.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from .norms import group_norm_heads
from .scan import linear_scan

if TYPE_CHECKING:
    from ..models.init import ParamInit

LOGW_MIN = -4.0
CHUNK = 16
LORA = 64


def init_rwkv_time(col: "ParamInit", n: int, cfg) -> dict:
    """One layer's time-mix weights (``src/repro/layers/rwkv.py:28-55``);
    ``n`` is its segment's layer count (the reference's stacked dimension,
    which scales the init)."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    return {
        "mu": col.param((5, d), "normal", axes=(None, "embed")),
        "wr": col.param((d, d), "scaled", fan=n, axes=("embed", "heads")),
        "wk": col.param((d, d), "scaled", fan=n, axes=("embed", "heads")),
        "wv": col.param((d, d), "scaled", fan=n, axes=("embed", "heads")),
        "wg": col.param((d, d), "scaled", fan=n, axes=("embed", "heads")),
        "w0": col.param((d,), "normal", axes=("embed",)),
        "wa": col.param((d, LORA), "scaled", fan=n, axes=("embed", "lora")),
        "wb": col.param((LORA, d), "scaled", fan=n, axes=("lora", "embed")),
        "u": col.param((h, hs), "normal", axes=("heads", "head_dim")),
        "gn_w": col.param((d,), "ones", axes=("norm",)),
        "gn_b": col.param((d,), "zeros", axes=("norm",)),
        "wo": col.param((d, d), "scaled", fan=n, axes=("heads", "embed")),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} per position; ``prev`` is the last token of the previous
    segment (decode state) or zeros (``src/repro/layers/rwkv.py:58-62``)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u):
    """r/k/v/logw [B,S,H,D] float32, u [H,D] -> (o [B,S,H,D], the final
    state [B,H,D,D]) (``src/repro/layers/rwkv.py:65-108``)."""
    b, s, h, dd = r.shape
    c = min(CHUNK, s)
    n = s // c
    assert s % c == 0, (s, c)
    rc, kc, vc, lw = (t.reshape(b, n, c, h, dd) for t in (r, k, v, logw))
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                 device=r.device), diagonal=-1)
    cum = torch.cumsum(lw, dim=2)                  # inclusive
    cum_prev = cum - lw                            # exclusive
    r_st = rc * torch.exp(cum_prev)
    k_in = kc * torch.exp(-cum)
    scores = torch.einsum("bnchk,bnghk->bnhcg", r_st, k_in) * mask
    o2 = torch.einsum("bnhcg,bnghv->bnchv", scores, vc)
    diag = torch.sum(rc * u * kc, dim=-1)          # [B,N,C,H]
    last = cum[:, :, -1]                           # [B,N,H,D]
    k_end = kc * torch.exp(last[:, :, None] - cum)
    kv = torch.einsum("bnchk,bnchv->bnhkv", k_end, vc)
    # the state after each chunk, then the state each chunk starts from
    states = linear_scan(torch.exp(last)[..., None], kv, dim=1)
    before = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]],
                       dim=1)
    o1 = torch.einsum("bnchk,bnhkv->bnchv", r_st, before)
    o = o1 + o2 + diag[..., None] * vc
    return o.reshape(b, s, h, dd), states[:, -1]


def wkv_step(state, r, k, v, logw, u):
    """Exact single-step recurrence (decode); r/k/v/logw [B,H,D]
    (``src/repro/layers/rwkv.py:111-116``)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, ..., None] * kv)
    state = state * torch.exp(logw)[..., None] + kv
    return state, o


def apply_rwkv_time(p: dict, x: torch.Tensor, cfg, *, state=None
                    ) -> tuple[torch.Tensor, dict | None]:
    """Time mix (``src/repro/layers/rwkv.py:119-161``). state (decode):
    {"shift": [B,d], "wkv": [B,H,D,D]} float32 (under a mesh, the rank's
    heads of ``wkv``), or None (prefill); returns (y, the new state or
    None)."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    prev = None if state is None else state["shift"].to(dtype)
    xs = _shift(x, prev)
    mu, _ = lay.weight(p["mu"], (None, "embed"), (5, d), dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))

    wr, spec = lay.weight(p["wr"], ("embed", "heads"), (d, d), dtype)
    wk, _ = lay.weight(p["wk"], ("embed", "heads"), (d, d), dtype)
    wv, _ = lay.weight(p["wv"], ("embed", "heads"), (d, d), dtype)
    wg, _ = lay.weight(p["wg"], ("embed", "heads"), (d, d), dtype)
    wo, _ = lay.weight(p["wo"], ("heads", "embed"), (d, d), dtype)
    tp = lay.on_model(spec, 1)
    c0, cl = lay.model_block(d) if tp else (0, d)
    if cl % hs:
        raise ValueError(f"{cl} channels a model rank do not hold whole "
                         f"heads of {hs}")
    hl = cl // hs
    if tp:
        xr, xk, xv, xg = (lay.copy_to_model(t) for t in (xr, xk, xv, xg))
    r = torch.matmul(xr, wr)
    k = torch.matmul(xk, wk)
    v = torch.matmul(xv, wv)
    g = F.silu(torch.matmul(xg, wg))
    wa, _ = lay.weight(p["wa"], ("embed", "lora"), (d, LORA), torch.float32)
    wb, _ = lay.weight(p["wb"], ("lora", "embed"), (LORA, d), torch.float32)
    w0, _ = lay.weight(p["w0"], ("embed",), (d,), torch.float32)
    lora = torch.tanh(torch.matmul(xw.float(), wa))
    logw = -torch.exp(w0 + torch.matmul(lora, wb))
    logw = torch.clamp_min(logw, LOGW_MIN)

    u, uspec = lay.weight(p["u"], ("heads", "head_dim"), (h, hs),
                          torch.float32)
    gn_w = p["gn_w"].reshape(h, hs)
    gn_b = p["gn_b"].reshape(h, hs)
    if tp:          # the rank's channels of what every rank holds whole
        logw = lay.slice_replicated(logw, 2, c0, cl)
        gn_w = lay.slice_replicated(gn_w, 0, c0 // hs, hl)
        gn_b = lay.slice_replicated(gn_b, 0, c0 // hs, hl)
        if not lay.on_model(uspec, 0):
            u = lay.slice_replicated(u, 0, c0 // hs, hl)
    rf, kf, vf = (t.float().reshape(b, s, hl, hs) for t in (r, k, v))
    lw = logw.reshape(b, s, hl, hs)

    if state is None:
        o, _ = _wkv_chunked(rf, kf, vf, lw, u)
        new_state = None
    else:
        if state["wkv"].shape[1] != hl:
            raise ValueError(f"a wkv state of {state['wkv'].shape[1]} heads "
                             f"for a rank computing {hl}")
        st, o1 = wkv_step(state["wkv"].float(), rf[:, 0], kf[:, 0],
                          vf[:, 0], lw[:, 0], u)
        o = o1[:, None]
        new_state = {"shift": x[:, -1].float(), "wkv": st}

    o = group_norm_heads(o, gn_w, gn_b)
    o = o.reshape(b, s, cl).to(dtype) * g
    y = torch.matmul(o, wo)
    return (lay.reduce_from_model(y) if tp else y), new_state


def init_rwkv_channel(col: "ParamInit", n: int, cfg) -> dict:
    """One layer's channel-mix weights (``src/repro/layers/rwkv.py:164-
    176``)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": col.param((2, d), "normal", axes=(None, "embed")),
        "wk": col.param((d, f), "scaled", fan=n, axes=("embed", "mlp")),
        "wv": col.param((f, d), "scaled", fan=n, axes=("mlp", "embed")),
        "wr": col.param((d, d), "scaled", fan=n, axes=("embed", "heads")),
    }


def apply_rwkv_channel(p: dict, x: torch.Tensor, *, state=None,
                       d_ff: int | None = None
                       ) -> tuple[torch.Tensor, dict | None]:
    """Channel mix (``src/repro/layers/rwkv.py:179-195``). state (decode):
    {"shift": [B,d]} float32, or None. Under a mesh the weights are the
    rank's blocks of a ``d_ff``-wide mix (``d_ff`` required)."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    d = x.shape[-1]
    prev = None if state is None else state["shift"].to(dtype)
    xs = _shift(x, prev)
    mu, _ = lay.weight(p["mu"], (None, "embed"), (2, d), dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    wk, spec_k = lay.weight(p["wk"], ("embed", "mlp"), (d, d_ff), dtype)
    wv, _ = lay.weight(p["wv"], ("mlp", "embed"), (d_ff, d), dtype)
    wr, spec_r = lay.weight(p["wr"], ("embed", "heads"), (d, d), dtype)
    k_tp, r_tp = lay.on_model(spec_k, 1), lay.on_model(spec_r, 1)
    k = torch.square(F.relu(torch.matmul(
        lay.copy_to_model(xk) if k_tp else xk, wk)))
    vv = torch.matmul(k, wv)
    if k_tp:
        vv = lay.reduce_from_model(vv)
    rr = torch.sigmoid(torch.matmul(lay.copy_to_model(xr) if r_tp else xr,
                                    wr))
    if r_tp:
        rr = lay.gather_model(rr, 2)
    new_state = None if state is None else {"shift": x[:, -1].float()}
    return rr * vv, new_state
