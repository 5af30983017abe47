"""Attention: GQA projections and an online-softmax core (the port of
``repro.layers.attention``).

``flash_attention`` is the reference's jnp online-softmax function in plain
PyTorch: it walks KV chunks carrying the running (max, denominator,
accumulator), with causal, sliding-window, valid-length and explicit
key-position masks, GQA head groups, split K and V head dims, and decode
(Sq = 1 against a cache at ``q_offset``). ``apply_gqa``'s prefill branch
(no cache, no window) is K5's function and calls its wrapper,
``kernels.flash_attention.flash_attention_fwd``: the kernel on CUDA
tensors, its plain version on CPU tensors. Decode stays
``flash_attention``, as the reference computes it outside any Pallas
kernel.

The prefill branch goes through ``K5Attention``, whose forward is K5's
wrapper; without a gradient to take that is all it does. Its backward
recomputes ``flash_attention`` (the reference's jnp function, which is what
JAX differentiates: the reference has no backward kernel) under autograd,
``BACKWARD_ROWS`` query rows at a time, and returns its gradients; a causal
row block reads only the key chunks its rows can see.

Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) ``apply_gqa`` runs on
this rank's blocks: split query heads with K5 (or, with a window, the plain
windowed ``flash_attention``) on the local heads, and a decode cache split
by kv heads or by positions, whose partial softmax states
``combine_key_blocks`` joins.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..kernels.flash_attention import flash_attention_fwd
from .rope import apply_rope, mrope_cos_sin, rope_cos_sin

if TYPE_CHECKING:
    from ..models.init import ParamInit

NEG_INF = -1e30
# query rows a backward step recomputes at once: rows are independent, so
# the gradient is the same function, and one step's float32 scores stay at
# B x BACKWARD_ROWS x H x Skv (2.1 GB at batch 8, 12 heads, 4,096 keys)
BACKWARD_ROWS = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset, window: int = 0,
                    kv_len: torch.Tensor | int | None = None,
                    k_positions: torch.Tensor | None = None,
                    chunk: int = 1024, scale: float | None = None,
                    stats: bool = False):
    """q [B,Sq,H,Dk], k [B,Skv,KVH,Dk], v [B,Skv,KVH,Dv] -> [B,Sq,H,Dv].

    ``q_offset``: absolute position of q[0] (decode passes the write
    position). ``window`` > 0 masks keys further than window-1 behind the
    query. ``kv_len``: keys at positions >= kv_len are masked.
    ``k_positions``: explicit absolute key positions [Skv] (ring-buffer
    caches; unwritten slots carry a large negative position).
    ``stats``: return the online softmax's float32 state instead, (the
    unnormalised accumulator [B,Sq,H,Dv], the running max and the
    denominator [B,Sq,H]), for a caller that combines key ranges.
    """
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    scale = scale if scale is not None else dk ** -0.5
    nc = max(skv // chunk, 1)
    chunk = skv // nc
    assert skv % nc == 0
    dev = q.device
    qf = q.reshape(b, sq, kvh, g, dk).float()
    if k_positions is None:
        k_positions = torch.arange(skv, dtype=torch.int32, device=dev)
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=dev)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kvh, g, dv), dtype=torch.float32, device=dev)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kch, vch, k_pos = k[:, sl], v[:, sl], k_positions[sl]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kch.float()) * scale
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vch.dtype).float(), vch.float())
        m = m_new
    if stats:
        return (acc.reshape(b, sq, h, dv), m.reshape(b, sq, h),
                l.reshape(b, sq, h))
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


class K5Attention(torch.autograd.Function):
    """``flash_attention_fwd`` (K5) forward; the backward recomputes the
    plain ``flash_attention`` under autograd, a block of query rows at a
    time, and returns its gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout, causal=ctx.causal),
                None)


def attention_backward(q, k, v, dout, *, causal: bool,
                       rows: int = BACKWARD_ROWS):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal,
    q_offset=0)`` against ``dout``, recomputed under autograd over
    ``rows`` query rows at a time (row block i as q_offset i: the same
    masks, so the same function). A causal block reads the keys up to the
    end of the last of ``flash_attention``'s key chunks that its rows can
    see: the chunks past it are fully masked, an exact no-op of the online
    softmax, and the chunks kept are the same, so the numbers are too. The
    blocks' dk and dv are summed in float32 and rounded to k's and v's
    dtype once."""
    sq, skv = q.shape[1], k.shape[1]
    if sq == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    chunk = skv // max(skv // 1024, 1)      # flash_attention's key chunk
    dqs, dk_sum, dv_sum = [], 0.0, 0.0
    with torch.enable_grad():
        kk = k.detach().requires_grad_()
        vv = v.detach().requires_grad_()
        for r0 in range(0, sq, rows):
            qq = q[:, r0:r0 + rows].detach().requires_grad_()
            end = skv
            if causal:
                seen = min(r0 + rows, sq)       # keys [0, seen) are visible
                end = min(skv, -(-seen // chunk) * chunk)
            out = flash_attention(qq, kk[:, :end], vv[:, :end],
                                  causal=causal, q_offset=r0, chunk=chunk)
            dq, dk, dv = torch.autograd.grad(
                out, (qq, kk, vv), dout[:, r0:r0 + rows])
            dqs.append(dq)
            dk_sum = dk_sum + dk.float()
            dv_sum = dv_sum + dv.float()
    return (torch.cat(dqs, dim=1), dk_sum.to(k.dtype), dv_sum.to(v.dtype))


def init_gqa(col: "ParamInit", n: int, d_model: int, n_heads: int,
             n_kv: int, head_dim: int) -> dict:
    """One layer's attention weights; ``n`` is its segment's layer count
    (the reference's stacked dimension, which scales the init)."""
    return {
        "wq": col.param((d_model, n_heads, head_dim), "scaled", fan=n,
                        axes=("embed", "heads", "head_dim")),
        "wk": col.param((d_model, n_kv, head_dim), "scaled", fan=n,
                        axes=("embed", "kv_heads", "head_dim")),
        "wv": col.param((d_model, n_kv, head_dim), "scaled", fan=n,
                        axes=("embed", "kv_heads", "head_dim")),
        "wo": col.param((n_heads, head_dim, d_model), "scaled", fan=n,
                        axes=("heads", "head_dim", "embed")),
    }


def combine_key_blocks(lay, acc: torch.Tensor, m: torch.Tensor,
                       l: torch.Tensor, split: bool) -> torch.Tensor:
    """The attention output (float32) from ``flash_attention(...,
    stats=True)``'s state over this rank's keys. ``split``: the keys are
    split over ``model`` (context parallel), and the states are joined by
    the online softmax's exact log-sum-exp combine of key blocks: each
    rank's weight is ``exp(m - max over ranks)``, 0 for a rank with no
    visible key. Over one rank every weight is exactly 1, so the output is
    ``flash_attention``'s own."""
    if split:
        from ..parallel.collectives import all_reduce_
        grp = lay.group("model")
        top = all_reduce_(m.clone(), grp, "max")
        w = torch.exp(m - top)
        l = all_reduce_(l * w, grp)
        acc = all_reduce_(acc * w[..., None], grp)
    return acc / torch.clamp_min(l[..., None], 1e-30)


def cache_kv_heads(cfg) -> int:
    """The decode cache's kv heads: ``kv_replicate_to`` where it widens the
    kv heads by a whole factor, else ``n_kv_heads`` (the reference's
    ``init_cache``)."""
    r = cfg.kv_replicate_to
    return r if r > cfg.n_kv_heads and r % cfg.n_kv_heads == 0 \
        else cfg.n_kv_heads


def cache_head_sharded(cfg, n_model: int) -> bool:
    """Whether a ``gqa`` decode cache splits its kv heads over ``model``
    (they divide it) rather than its positions (context parallel): the
    reference's ``launch/specs.py`` ``cache_specs`` rule."""
    return cache_kv_heads(cfg) % n_model == 0


def _rope(cfg, pos_ids, hd):
    if cfg.mrope_sections:
        return mrope_cos_sin(pos_ids, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_cos_sin(pos_ids, hd, cfg.rope_theta)


def gqa_projections(lay, p: dict, x: torch.Tensor, cfg, pos_ids, *,
                    mrope: bool = True):
    """A GQA block's projections on this rank of ``lay``: (q, k, v rotated,
    ``wo`` in ``x``'s dtype, whether the query heads and the kv heads split
    over ``model``). ``x`` enters the split products through
    ``copy_to_model``; ``mrope`` False rotates by the plain rope even where
    the config sets M-RoPE sections (the reference's ring decode)."""
    dtype = x.dtype
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    wq, sq = lay.weight(p["wq"], ("embed", "heads", "head_dim"), (d, h, hd),
                        dtype)
    wk, sk = lay.weight(p["wk"], ("embed", "kv_heads", "head_dim"),
                        (d, kv, hd), dtype)
    wv, _ = lay.weight(p["wv"], ("embed", "kv_heads", "head_dim"),
                       (d, kv, hd), dtype)
    wo, _ = lay.weight(p["wo"], ("heads", "head_dim", "embed"), (h, hd, d),
                       dtype)
    q_tp, kv_tp = lay.on_model(sq, 1), lay.on_model(sk, 1)
    if kv_tp and not q_tp:
        raise ValueError("kv heads split over model with the query heads "
                         "whole")
    xt = lay.copy_to_model(x) if q_tp else x
    q = torch.einsum("bsd,dhk->bshk", xt, wq)
    xk = xt if kv_tp else x
    k = torch.einsum("bsd,dhk->bshk", xk, wk)
    v = torch.einsum("bsd,dhk->bshk", xk, wv)
    cos, sin = (_rope(cfg, pos_ids, hd) if mrope
                else rope_cos_sin(pos_ids, hd, cfg.rope_theta))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, wo, q_tp, \
        kv_tp


def apply_gqa(p: dict, x: torch.Tensor, cfg, *, pos_ids, cache=None,
              write_pos=None, window: int = 0, causal: bool = True
              ) -> tuple[torch.Tensor, dict | None]:
    """GQA block. cache: {"k","v"} [B, S_cache, KVH, D] (decode) or None.

    pos_ids: [B, S] (or [3, B, S] when cfg.mrope_sections is set).
    write_pos: int position at which this step's K/V go into the cache.
    Decode writes the cache in place and returns the same tensors.

    Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the weights and
    the cache are this rank's blocks (the production layout; without one,
    ``parallel.collectives.WHOLE``: nothing is split and no collective
    runs). Query heads split over ``model`` where the rules split them:
    ``x`` enters through ``copy_to_model``, each rank projects its heads,
    and the row-parallel ``wo`` ends in one ``reduce_from_model``. The kv
    heads follow their own spec: split with the query heads, or computed
    whole and narrowed to the ones this rank's query heads read
    (``slice_replicated``). Heads the rules leave whole are computed whole
    on every rank, with no collective.

    Decode: a cache whose kv heads divide ``model`` is split by heads, and
    each rank attends with the query heads that read its kv heads; else it
    is split by positions, each rank attends over its positions with every
    query head, and the partial softmax states are combined over ``model``
    by an exact log-sum-exp (the online softmax's combine of key blocks).
    The new token's k and v go to the rank holding position
    ``write_pos``. A windowed prefill (recurrentgemma's ``wattn``) runs the
    plain windowed ``flash_attention`` on the rank's heads; its decode goes
    through the ring (``models.lm._apply_ring_block``)."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    h, kv = cfg.n_heads, cfg.n_kv_heads
    q, k, v, wo, q_tp, kv_tp = gqa_projections(lay, p, x, cfg, pos_ids)
    n = lay.size("model")
    h0, hl = lay.model_block(h) if q_tp else (0, h)

    if cache is None:
        g = h // kv
        if q_tp and not kv_tp:
            kv0, kv1 = h0 // g, (h0 + hl - 1) // g + 1
            if hl % (kv1 - kv0) or any((h0 + i) // g - kv0 != i // (
                    hl // (kv1 - kv0)) for i in range(hl)):
                raise ValueError(f"query heads {h0}..{h0 + hl - 1} do not "
                                 f"read whole groups of {kv} kv heads")
            k = lay.slice_replicated(k, 2, kv0, kv1 - kv0)
            v = lay.slice_replicated(v, 2, kv0, kv1 - kv0)
        if window:
            out = flash_attention(q, k, v, causal=causal, q_offset=0,
                                  window=window)
        else:
            out = K5Attention.apply(q, k, v, causal)
        y = torch.einsum("bshk,hkd->bsd", out, wo)
        return (lay.reduce_from_model(y) if q_tp else y), None

    ck, cv = cache["k"], cache["v"]
    s = k.shape[1]
    if cache_head_sharded(cfg, n):
        kvc = ck.shape[-2] * n          # the whole cache's kv heads
        if kvc != kv:                   # cfg.kv_replicate_to, as the reference
            k = torch.repeat_interleave(k, kvc // kv, dim=2)
            v = torch.repeat_interleave(v, kvc // kv, dim=2)
        if h % kvc:
            raise ValueError(f"{h} query heads do not group over {kvc} "
                             "kv heads")
        c0, cl = lay.model_block(kvc)
        if not kv_tp:                   # k, v computed whole: this block
            k, v = k[:, :, c0:c0 + cl], v[:, :, c0:c0 + cl]
        ck[:, write_pos:write_pos + s] = k.to(ck.dtype)
        cv[:, write_pos:write_pos + s] = v.to(cv.dtype)
        g = h // kvc
        qa, ql = c0 * g, cl * g         # the query heads that read them
        if not q_tp:
            q, wo = q[:, :, qa:qa + ql], wo[qa:qa + ql]
        out = flash_attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                              q_offset=write_pos, window=window)
        y = torch.einsum("bshk,hkd->bsd", out, wo)
        return lay.reduce_from_model(y), {"k": ck, "v": cv}

    # context parallel: this rank's positions [s0, s0 + sl)
    kvc = cache_kv_heads(cfg)
    if kvc != kv:
        k = torch.repeat_interleave(k, kvc // kv, dim=2)
        v = torch.repeat_interleave(v, kvc // kv, dim=2)
    sl = ck.shape[1]
    s0 = lay.rank("model") * sl
    if s0 <= write_pos < s0 + sl:
        if write_pos + s > s0 + sl:
            raise ValueError("a decode write crosses two ranks' positions")
        ck[:, write_pos - s0:write_pos - s0 + s] = k.to(ck.dtype)
        cv[:, write_pos - s0:write_pos - s0 + s] = v.to(cv.dtype)
    if q_tp:
        q = lay.gather_model(q, 2)
    kpos = s0 + torch.arange(sl, dtype=torch.int32, device=x.device)
    acc, m, l = flash_attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                                q_offset=write_pos, k_positions=kpos,
                                chunk=min(1024, sl), stats=True)
    out = combine_key_blocks(lay, acc, m, l, True).to(dtype)
    if q_tp:
        y = torch.einsum("bshk,hkd->bsd", out[:, :, h0:h0 + hl], wo)
        return lay.reduce_from_model(y), {"k": ck, "v": cv}
    return torch.einsum("bshk,hkd->bsd", out, wo), {"k": ck, "v": cv}
