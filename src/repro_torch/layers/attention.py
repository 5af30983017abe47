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
                    chunk: int = 1024, scale: float | None = None
                    ) -> torch.Tensor:
    """q [B,Sq,H,Dk], k [B,Skv,KVH,Dk], v [B,Skv,KVH,Dv] -> [B,Sq,H,Dv].

    ``q_offset``: absolute position of q[0] (decode passes the write
    position). ``window`` > 0 masks keys further than window-1 behind the
    query. ``kv_len``: keys at positions >= kv_len are masked.
    ``k_positions``: explicit absolute key positions [Skv] (ring-buffer
    caches; unwritten slots carry a large negative position).
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


def apply_gqa(p: dict, x: torch.Tensor, cfg, *, pos_ids, cache=None,
              write_pos=None, window: int = 0, causal: bool = True
              ) -> tuple[torch.Tensor, dict | None]:
    """GQA block. cache: {"k","v"} [B, S_cache, KVH, D] (decode) or None.

    pos_ids: [B, S] (or [3, B, S] when cfg.mrope_sections is set).
    write_pos: int position at which this step's K/V go into the cache.
    Decode writes the cache in place and returns the same tensors.
    """
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dtype))

    hd = q.shape[-1]
    if cfg.mrope_sections:
        cos, sin = mrope_cos_sin(pos_ids, hd, cfg.rope_theta,
                                 cfg.mrope_sections)
    else:
        cos, sin = rope_cos_sin(pos_ids, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        if window == 0:
            out = K5Attention.apply(q, k, v, causal)
        else:
            out = flash_attention(q, k, v, causal=causal, q_offset=0,
                                  window=window)
        new_cache = None
    else:
        kvh_cache = cache["k"].shape[-2]
        if kvh_cache != k.shape[-2]:
            # KV-head replication (cfg.kv_replicate_to), as the reference
            rep = kvh_cache // k.shape[-2]
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        ck, cv = cache["k"], cache["v"]
        s = k.shape[1]
        ck[:, write_pos:write_pos + s] = k.to(ck.dtype)
        cv[:, write_pos:write_pos + s] = v.to(cv.dtype)
        out = flash_attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                              q_offset=write_pos, window=window)
        new_cache = {"k": ck, "v": cv}
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return y, new_cache
