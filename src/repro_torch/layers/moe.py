"""Mixture-of-Experts: top-k router, capacity-based dispatch and optional
shared experts (the port of ``repro.layers.moe``).

``apply_moe`` computes the reference's ``_apply_moe_gspmd``, the
"dropping" MoE: ``route`` picks each token's top-k experts from float32
router logits (padded experts get -1e30 and never win), weights them by the
softmax over the k gates, and numbers each (token, slot) pair within its
expert by an exclusive cumulative count over the pairs in token-major order;
pairs at or past the capacity are dropped (their combine weight is 0). The
kept tokens are scattered into an ``[E, cap, d]`` buffer, the experts run
as batched products, and each token adds its k contributions in slot order
in ``cfg.dtype``: a fixed order, the reference's sequential scatter-add,
where an ``index_add_`` on the card would add in the order its atomics land.

``moe_impl="shard_map"`` (the production override) computes the same
function here: the reference runs its expert-parallel body only under a
mesh with a ``model`` axis, and the port has no mesh. That body
(``_apply_moe_shard_map``) waits for ``parallel/sharding.py`` (ROADMAP queue
1, item 12g). The expert counts are padded to a multiple of 16, as the
reference pads them for its mesh (qwen2-moe's 60 -> 64).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple

import torch
import torch.nn.functional as F

from .mlp import apply_mlp, init_mlp

if TYPE_CHECKING:
    from ..models.init import ParamInit

PAD_LOGIT = -1e30


def padded_experts(n_experts: int, mesh_divisor: int = 16) -> int:
    return int(math.ceil(n_experts / mesh_divisor) * mesh_divisor)


def capacity(tokens: int, cfg, n_experts: int) -> int:
    """Slots an expert holds for a call of ``tokens`` tokens: the mean load
    times ``capacity_factor``, rounded up to a multiple of 128."""
    cap = int(math.ceil(tokens * cfg.top_k / n_experts
                        * cfg.capacity_factor))
    return max(((cap + 127) // 128) * 128, 128)


def init_moe(col: "ParamInit", n: int, cfg) -> dict:
    """One layer's router, experts (over the padded count) and shared MLP;
    ``n`` is its segment's layer count (the reference's stacked dimension,
    which scales the init)."""
    d, f = cfg.d_model, cfg.expert_dff
    e = padded_experts(cfg.n_experts)
    p = {
        "router": col.param((d, e), "scaled", fan=n),
        "w_gate": col.param((e, d, f), "scaled", fan=n),
        "w_up": col.param((e, d, f), "scaled", fan=n),
        "w_down": col.param((e, f, d), "scaled", fan=n),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(col, n, d, cfg.shared_dff or cfg.expert_dff)
    return p


class Routing(NamedTuple):
    """One call's routing of T tokens to k of E experts."""
    idx: torch.Tensor        # [T, k] int64, experts by descending logit
    weights: torch.Tensor    # [T, k] float32, softmax over the k gates
    pos: torch.Tensor        # [T, k] int64, place of the pair in its expert
    keep: torch.Tensor       # [T, k] bool, pos < cap
    cap: int
    aux: torch.Tensor        # () float32, the Switch load-balance loss


def route(p: dict, x: torch.Tensor, cfg) -> Routing:
    """Top-k routing of x [..., d] (flattened to T tokens) as the
    reference's ``_apply_moe_gspmd`` routes. Equal logits go to the lower
    expert, as ``jax.lax.top_k`` breaks ties (a stable descending sort)."""
    e = p["router"].shape[-1]
    k = cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    cap = capacity(t, cfg, e)
    logits = xt.float() @ p["router"].float()
    if e > cfg.n_experts:                    # padded experts never win
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], PAD_LOGIT, logits)
    gates, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    weights = torch.softmax(gates, dim=-1)

    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = (me * ce).sum() * float(e)

    flat = F.one_hot(idx.reshape(-1), e)               # [T*k, E], token-major
    pos = ((flat.cumsum(dim=0) - flat) * flat).sum(dim=-1).reshape(t, k)
    return Routing(idx, weights, pos, pos < cap, cap, aux)


def apply_moe(p: dict, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux loss): the reference's
    ``_apply_moe_gspmd``."""
    dtype = x.dtype
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    e = p["router"].shape[-1]
    r = route(p, x, cfg)
    xt = x.reshape(t, d)
    eid = r.idx.reshape(-1)
    pid = torch.where(r.keep, r.pos, r.cap - 1).reshape(-1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    wk = torch.where(r.keep, r.weights, 0.0)

    # kept pairs are unique (expert, slot); a dropped pair adds exact zeros
    buf = torch.zeros((e, r.cap, d), dtype=dtype, device=x.device)
    buf.index_put_((eid, pid),
                   xt[tok] * r.keep.reshape(-1, 1).to(dtype),
                   accumulate=True)
    h = (F.silu(torch.bmm(buf, p["w_gate"].to(dtype)))
         * torch.bmm(buf, p["w_up"].to(dtype)))
    out_buf = torch.bmm(h, p["w_down"].to(dtype))

    contrib = (out_buf[eid, pid] * wk.reshape(-1, 1).to(dtype)
               ).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):                    # slot order, in cfg.dtype
        y = y + contrib[:, j]
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, "swiglu")
    return y, r.aux
