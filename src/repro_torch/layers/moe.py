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

``moe_impl="shard_map"`` (the production override) under a mesh with a
``model`` dim (``parallel.set_mesh_rules``) takes the expert-parallel body
instead, the reference's ``_apply_moe_shard_map``. It runs on every rank of
the mesh with that rank's blocks: ``x`` its batch slice (over ``pod`` and
``data``), ``w_gate``/``w_up``/``w_down`` its ``E / n_model`` experts (dim
0 over ``model``), the router whole; every ``embed`` dim that FSDP's rule
splits is gathered at use (``parallel.collectives``), and the shared MLP
is tensor-parallel where the rules split its ``mlp`` dim. Each rank routes
its own tokens, with a capacity taken from its own token count, keeps only
the pairs of its experts, runs them and combines locally; then exactly one
all-reduce over the ``model`` group a layer (``ep_all_reduces`` counts
them; ``parallel.collectives.LOG`` logs it with the rest) sums each
token's contributions and the shared MLP's partial sums. ``aux``'s expert
means are averaged over the batch ranks. Which pairs drop is decided per
rank, so with drops the result differs from the gspmd path's; its parity
target is the reference's ``_apply_moe_shard_map``. With one rank it
computes the gspmd path's function, op for op.

``moe_impl="gspmd"`` under a ``DeviceMesh`` runs the same body on the
rank's blocks, but computes the reference's ``_apply_moe_gspmd`` of the
global batch: the capacity is taken from the global token count (the
rank's tokens times the batch ranks), and each (token, slot) pair's
position within its expert is offset by the pairs the lower batch ranks
route to it (their rows come first in the global token order), from one
all-gather a layer, over each batch dim, of the counts of this rank's
experts (``Layout.batch_exclusive_sum``). So exactly the pairs of the
unsharded gspmd path are kept, whatever the mesh; the combine ends in the
layer's one all-reduce over ``model`` (tagged ``GSPMD_TAG``).

Gradients: each ``model`` rank computes the same loss on the same summed
``y``, so that all-reduce passes its gradient through unchanged
(Megatron's forward all-reduce, backward identity), and the gradients that
a rank's experts give ``x`` and the combine weights are summed over
``model`` in the backward (forward identity, backward all-reduce). The
router's gradient from ``aux`` is thus counted once, and the router and
``x`` get the whole gradient on every ``model`` rank. Over the batch ranks
the gradients of the router, the shared MLP and the experts are partial
and sum to the whole (the data-parallel all-reduce is the caller's:
``models.steps``), with each rank's loss adding the replicated ``aux``
once: the batch mean of ``aux``'s terms divides its gradient by the batch
ranks.
The expert counts are padded to a multiple of 16, as the reference pads
them for its mesh (qwen2-moe's 60 -> 64).
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
        "router": col.param((d, e), "scaled", fan=n, axes=("embed", None)),
        "w_gate": col.param((e, d, f), "scaled", fan=n,
                            axes=("expert", "embed", "expert_mlp")),
        "w_up": col.param((e, d, f), "scaled", fan=n,
                          axes=("expert", "embed", "expert_mlp")),
        "w_down": col.param((e, f, d), "scaled", fan=n,
                            axes=("expert", "expert_mlp", "embed")),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(col, n, d, cfg.shared_dff or cfg.expert_dff)
    return p


class Routing(NamedTuple):
    """One call's routing of T tokens to k of E experts."""
    idx: torch.Tensor        # [T, k] int64, experts by descending logit
    weights: torch.Tensor    # [T, k] float32, softmax over the k gates
    pos: torch.Tensor        # [T, k] int64, place of the pair in its expert
    keep: torch.Tensor       # [T, k] bool, pos < cap (and the expert local)
    cap: int
    aux: torch.Tensor        # () float32, the Switch load-balance loss


def route(p: dict, x: torch.Tensor, cfg, *, experts: range | None = None,
          batch_mean=None, batch_offsets=None, n_batch: int = 1
          ) -> Routing:
    """Top-k routing of x [..., d] (flattened to T tokens) as the
    reference's ``_apply_moe_gspmd`` routes. Equal logits go to the lower
    expert, as ``jax.lax.top_k`` breaks ties (a stable descending sort).

    ``experts`` (the bodies over a mesh): only the pairs of those experts
    are numbered, within their expert, and kept; the rest get position 0
    and ``keep`` False. ``batch_mean`` averages the aux loss's two expert
    means ``[2, E]`` over the batch ranks. The gspmd body over a mesh routes
    the rank's tokens as the ``n_batch``-times larger global batch does:
    the capacity of ``n_batch * T`` tokens, and each pair's position offset
    by ``batch_offsets(count)``, the pairs the lower batch ranks give each
    of ``experts`` (``count``: this rank's)."""
    e = p["router"].shape[-1]
    k = cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    t = xt.shape[0]
    cap = capacity(t * n_batch, cfg, e)
    logits = xt.float() @ p["router"].float()
    if e > cfg.n_experts:                    # padded experts never win
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], PAD_LOGIT, logits)
    gates, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    weights = torch.softmax(gates, dim=-1)

    probs = torch.softmax(logits, dim=-1)
    means = torch.stack([probs.mean(dim=0),
                         F.one_hot(idx[:, 0], e).float().mean(dim=0)])
    if batch_mean is not None:
        means = batch_mean(means)
    aux = (means[0] * means[1]).sum() * float(e)

    eid = idx.reshape(-1)                    # token-major pairs
    if experts is None:
        flat = F.one_hot(eid, e)
    else:
        mine = (eid >= experts.start) & (eid < experts.stop)
        flat = (F.one_hot(torch.where(mine, eid - experts.start, 0),
                          len(experts)) * mine[:, None])
    pos = ((flat.cumsum(dim=0) - flat) * flat).sum(dim=-1)
    if batch_offsets is not None:
        before = batch_offsets(flat.sum(dim=0))
        pos = pos + (flat * before).sum(dim=-1)
    keep = pos < cap if experts is None else mine & (pos < cap)
    return Routing(idx, weights, pos.reshape(t, k), keep.reshape(t, k), cap,
                   aux)


def _experts(p: dict, xt: torch.Tensor, eid: torch.Tensor, r: Routing,
             weights: torch.Tensor) -> torch.Tensor:
    """The kept pairs of ``r`` through the experts of ``p`` (``eid``: each
    pair's expert among them), combined: [T, d] in ``xt``'s dtype."""
    dtype = xt.dtype
    t, d = xt.shape
    k = r.idx.shape[1]
    pid = torch.where(r.keep, r.pos, r.cap - 1).reshape(-1)
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    wk = torch.where(r.keep, weights, 0.0)

    # kept pairs are unique (expert, slot); a dropped pair adds exact zeros
    buf = torch.zeros((p["w_gate"].shape[0], r.cap, d), dtype=dtype,
                      device=xt.device)
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
    return y


def apply_moe(p: dict, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux loss): the reference's
    ``_apply_moe_gspmd``, or its ``_apply_moe_shard_map`` for
    ``moe_impl="shard_map"`` under a mesh with a ``model`` dim; under a
    ``DeviceMesh`` both run on the rank's blocks (``_apply_moe_over_mesh``)."""
    from ..parallel.collectives import layout
    from ..parallel.sharding import current, mesh_dims
    lay = layout()
    if cfg.moe_impl == "shard_map":
        mesh, _ = current()
        if mesh is not None and "model" in mesh_dims(mesh):
            if lay.mesh is None:
                raise TypeError("the expert-parallel MoE runs over a "
                                "DeviceMesh, not a MeshShape")
            return _apply_moe_over_mesh(lay, p, x, cfg, gspmd=False)
    if lay.mesh is not None:
        return _apply_moe_over_mesh(lay, p, x, cfg, gspmd=True)
    b, s, d = x.shape
    r = route(p, x, cfg)
    y = _experts(p, x.reshape(b * s, d), r.idx.reshape(-1), r, r.weights)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, "swiglu", _shared_dff(cfg))
    return y, r.aux


def _shared_dff(cfg) -> int:
    return cfg.shared_dff or cfg.expert_dff


def _moe_weights(lay, p: dict, x: torch.Tensor, cfg) -> dict:
    """The router (in its own dtype: routing is float32) and the experts
    (cast to ``x``'s dtype, which the body would cast them to) with FSDP's
    ``embed`` dims gathered, each checked against the block the active
    rules give this rank."""
    d, f = x.shape[-1], cfg.expert_dff
    e = padded_experts(cfg.n_experts)
    full = {"router": ((d, e), ("embed", None)),
            "w_gate": ((e, d, f), ("expert", "embed", "expert_mlp")),
            "w_up": ((e, d, f), ("expert", "embed", "expert_mlp")),
            "w_down": ((e, f, d), ("expert", "expert_mlp", "embed"))}
    return {k: lay.weight(p[k], axes, shape,
                          p[k].dtype if k == "router" else x.dtype)[0]
            for k, (shape, axes) in full.items()}


# ---------------------------------------------------------- over a mesh ----

EP_TAG = "moe-ep"         # the expert-parallel body's all-reduce in LOG.tags
GSPMD_TAG = "moe-gspmd"   # the gspmd body's over a mesh


def __getattr__(name: str):
    if name == "ep_all_reduces":    # the body's forward all-reduces so far
        from ..parallel.collectives import LOG
        return LOG.tags.get(EP_TAG, 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _apply_moe_over_mesh(lay, p: dict, x: torch.Tensor, cfg, *,
                         gspmd: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE on this rank's blocks (see the module docstring): x
    [B_loc,S,d] -> (y [B_loc,S,d], aux). ``gspmd`` False: the reference's
    ``_apply_moe_shard_map`` (``src/repro/layers/moe.py:122``), local
    routing and capacity; True: its ``_apply_moe_gspmd``
    (``src/repro/layers/moe.py:60-120``) of the global batch. The router's
    and the experts' ``embed`` dims are gathered at use where FSDP's rule
    splits them; the shared MLP is tensor-parallel where the rules split
    its ``mlp`` dim, and then its partial sum joins the experts' in the
    layer's one all-reduce over ``model``."""
    p = dict(p, **_moe_weights(lay, p, x, cfg))
    e = p["router"].shape[-1]
    e_loc = p["w_gate"].shape[0]
    if e_loc * lay.size("model") != e:
        raise ValueError(f"{e_loc} local experts on {lay.size('model')} "
                         f"model ranks for a router over {e}")
    base = lay.rank("model") * e_loc
    b, s, d = x.shape
    r = route(p, x, cfg, experts=range(base, base + e_loc),
              batch_mean=lay.batch_mean,
              batch_offsets=lay.batch_exclusive_sum if gspmd else None,
              n_batch=lay.n_batch if gspmd else 1)
    xt = lay.copy_to_model(x.reshape(b * s, d))
    weights = lay.copy_to_model(r.weights)
    mine = (r.idx >= base) & (r.idx < base + e_loc)
    eid = torch.where(mine, r.idx - base, 0).reshape(-1)
    y = _experts(p, xt, eid, r, weights).reshape(b, s, d)
    shared = split = None
    if "shared" in p:
        shared, split = apply_mlp(p["shared"], x, "swiglu", _shared_dff(cfg),
                                  partial=True)
        if split:
            y = y + shared
    y = lay.reduce_from_model(y, GSPMD_TAG if gspmd else EP_TAG)
    if shared is not None and not split:
        y = y + shared
    return y, r.aux
