"""Multi-head Latent Attention (DeepSeek-V2), the port of
``repro.layers.mla``.

K and V come from a shared ``kv_lora``-wide latent ``c`` plus one rope key
band shared by every head; the decode cache holds only ``c`` and
``k_rope`` (``kv_lora + rope_head_dim`` values a token), written in place.
Decode has two forms, chosen by ``cfg.mla_absorb`` as in the reference:
the naive one expands per-head K and V over the whole cache
(``_project_kv``); the weight-absorbed one folds ``wkv_b`` into the query
and the output and attends in the latent space (``_decode_absorbed``).

The attention of prefill and of naive decode is the plain
``layers.attention.flash_attention``, on the card too, with
``scale = (nope + rope) ** -0.5``: the reference computes it in jnp outside
any Pallas kernel, and K5 takes neither the key dim ``nope + rope`` (192 at
full width) nor a value dim other than the key dim.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .attention import NEG_INF, flash_attention
from .norms import rms_norm
from .rope import apply_rope, rope_cos_sin

if TYPE_CHECKING:
    from ..models.init import ParamInit


def init_mla(col: "ParamInit", n: int, cfg) -> dict:
    """One layer's MLA weights; ``n`` is its segment's layer count (the
    reference's stacked dimension, which scales the init)."""
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    p = {
        "wkv_a": col.param((d, cfg.kv_lora + cfg.rope_head_dim), "scaled",
                           fan=n, axes=("embed", "kv_lora")),
        "kv_norm": col.param((cfg.kv_lora,), "ones", axes=("norm",)),
        "wkv_b": col.param((cfg.kv_lora, h,
                            cfg.nope_head_dim + cfg.v_head_dim), "scaled",
                           fan=n, axes=("kv_lora", "heads", "head_dim")),
        "wo": col.param((h, cfg.v_head_dim, d), "scaled", fan=n,
                        axes=("heads", "head_dim", "embed")),
    }
    if cfg.q_lora:
        p["wq_a"] = col.param((d, cfg.q_lora), "scaled", fan=n,
                              axes=("embed", "q_lora"))
        p["q_norm"] = col.param((cfg.q_lora,), "ones", axes=("norm",))
        p["wq_b"] = col.param((cfg.q_lora, h, qk), "scaled", fan=n,
                              axes=("q_lora", "heads", "head_dim"))
    else:
        p["wq"] = col.param((d, h, qk), "scaled", fan=n,
                            axes=("embed", "heads", "head_dim"))
    return p


def _project_kv(p: dict, c: torch.Tensor, cfg, dtype):
    """Latent c [B,S,kv_lora] -> k_nope [B,S,H,nope], v [B,S,H,v_dim]."""
    kv = torch.einsum("bsl,lhd->bshd", c.to(dtype), p["wkv_b"].to(dtype))
    return kv[..., :cfg.nope_head_dim], kv[..., cfg.nope_head_dim:]


def _decode_absorbed(p, cfg, q_nope, q_rope, c, k_rope, pos: int, dtype):
    """Weight-absorbed decode: scores and context in the latent space
    (q~ = q_nope @ W_bk a head), the context projected to v once; no
    [B,S,H,nope+v] expansion of the cache. -> [B,1,H,v]."""
    wb = p["wkv_b"].to(dtype)                           # [L, H, nope+v]
    wbk = wb[..., :cfg.nope_head_dim]
    wbv = wb[..., cfg.nope_head_dim:]
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wbk)
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    s_lat = torch.einsum("bshl,btl->bhst", q_lat, c)    # [B,H,1,S]
    s_rope = torch.einsum("bshd,btd->bhst", q_rope, k_rope)
    s = (s_lat + s_rope).float() * scale
    t_pos = torch.arange(c.shape[1], dtype=torch.int32, device=c.device)
    s = torch.where(t_pos[None, None, None, :] <= pos, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(dtype)
    ctx = torch.einsum("bhst,btl->bshl", prob, c)       # [B,1,H,L]
    return torch.einsum("bshl,lhv->bshv", ctx, wbv)


def apply_mla(p: dict, x: torch.Tensor, cfg, *, pos_ids, cache=None,
              write_pos=None) -> tuple[torch.Tensor, dict | None]:
    """MLA block. cache: {"c": [B,Sc,kv_lora], "k_rope": [B,Sc,rope]}
    (decode, written in place at ``write_pos`` and returned) or None."""
    dtype = x.dtype
    nope = cfg.nope_head_dim
    if cfg.q_lora:
        qa = rms_norm(torch.einsum("bsd,dl->bsl", x, p["wq_a"].to(dtype)),
                      p["q_norm"])
        q = torch.einsum("bsl,lhd->bshd", qa, p["wq_b"].to(dtype))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = torch.einsum("bsd,dl->bsl", x, p["wkv_a"].to(dtype))
    c_new = rms_norm(kv_a[..., :cfg.kv_lora], p["kv_norm"])
    k_rope_new = kv_a[..., cfg.kv_lora:]                # [B,S,rope]

    cos, sin = rope_cos_sin(pos_ids, cfg.rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new, cos, sin)       # shared band

    if cache is None:
        c, k_rope, q_offset, new_cache = c_new, k_rope_new, 0, None
    else:
        cc, ck = cache["c"], cache["k_rope"]
        s = c_new.shape[1]
        cc[:, write_pos:write_pos + s] = c_new.to(cc.dtype)
        ck[:, write_pos:write_pos + s] = k_rope_new.to(ck.dtype)
        new_cache = {"c": cc, "k_rope": ck}
        c, k_rope, q_offset = cc.to(dtype), ck.to(dtype), write_pos
        if cfg.mla_absorb:
            y = _decode_absorbed(p, cfg, q_nope, q_rope, c, k_rope,
                                 write_pos, dtype)
            return (torch.einsum("bshk,hkd->bsd", y, p["wo"].to(dtype)),
                    new_cache)

    k_nope, v = _project_kv(p, c, cfg, dtype)           # full-head K/V
    k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3],
                                            cfg.rope_head_dim)
    k = torch.cat([k_nope, k_rope_b], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    out = flash_attention(qq, k, v, causal=True, q_offset=q_offset,
                          scale=(nope + cfg.rope_head_dim) ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype)), new_cache
