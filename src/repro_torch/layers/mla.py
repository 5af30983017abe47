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

Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the weights are this
rank's blocks (the production layout, ``parallel.collectives``): the query
heads split over ``model`` (``wq``, or ``wq_a`` and ``q_norm`` computed
whole and ``wq_b`` split), ``wkv_a`` and ``kv_norm`` computed whole on every
rank (the rules give ``kv_lora`` no mesh dim), ``wkv_b`` and ``wo`` split
by heads, ending in one ``reduce_from_model``. The decode cache is split
over positions (``act_kv_seq``): each rank attends over its positions with
every head and the partial softmax states are joined exactly over
``model``. The naive decode projects its positions' K and V with the whole
``wkv_b`` (gathered over ``model``) and combines by the log-sum-exp
(``attention.combine_key_blocks``); the absorbed decode takes the latent
query of every head, reduces the scores' max and denominator over
``model`` before rounding its probabilities to the activation dtype, as the
reference rounds them, sums the ranks' latent contexts, and narrows the
context back to the rank's heads before ``wbv`` and ``wo``. Without a mesh
(``WHOLE``) the same body runs with nothing split and no collective.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .attention import NEG_INF, combine_key_blocks, flash_attention
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


def _project_kv(wkv_b: torch.Tensor, c: torch.Tensor, cfg, dtype):
    """Latent c [B,S,kv_lora] -> k_nope [B,S,H,nope], v [B,S,H,v_dim]
    (``wkv_b`` in ``dtype``, over the heads it holds)."""
    kv = torch.einsum("bsl,lhd->bshd", c.to(dtype), wkv_b)
    return kv[..., :cfg.nope_head_dim], kv[..., cfg.nope_head_dim:]


def _softmax_over_model(lay, s: torch.Tensor, split: bool) -> torch.Tensor:
    """softmax over the last dim of the scores ``s`` (float32), whose
    positions ``split`` over ``model``: the max and the denominator are
    reduced over the ranks first, so each rank's block of probabilities is
    that of the whole row."""
    from ..parallel.collectives import all_reduce_
    top = s.amax(dim=-1, keepdim=True)
    if split:
        top = all_reduce_(top, lay.group("model"), "max")
    p = torch.exp(s - top)
    den = p.sum(dim=-1, keepdim=True)
    if split:
        den = all_reduce_(den, lay.group("model"))
    return p / den


def _decode_absorbed(lay, cfg, wkv_b, q_nope, q_rope, c, k_rope, kpos,
                     pos: int, dtype, heads: tuple[int, int] | None):
    """Weight-absorbed decode: scores and context in the latent space
    (q~ = q_nope @ W_bk a head), the context projected to v once; no
    [B,S,H,nope+v] expansion of the cache. -> [B,1,H_loc,v]. ``c``,
    ``k_rope`` and ``kpos`` are this rank's positions; ``heads`` (start,
    length) the rank's block of the heads where they split over ``model``
    (the latent query is then gathered over the heads and the context
    narrowed back)."""
    from ..parallel.collectives import all_reduce_
    split = lay.mesh is not None
    wbk = wkv_b[..., :cfg.nope_head_dim]                # [L, H, nope]
    wbv = wkv_b[..., cfg.nope_head_dim:]
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wbk)
    if heads is not None:
        q_lat, q_rope = lay.gather_model(q_lat, 2), lay.gather_model(q_rope,
                                                                     2)
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    s_lat = torch.einsum("bshl,btl->bhst", q_lat, c)    # [B,H,1,S]
    s_rope = torch.einsum("bshd,btd->bhst", q_rope, k_rope)
    s = (s_lat + s_rope).float() * scale
    s = torch.where(kpos[None, None, None, :] <= pos, s, NEG_INF)
    prob = _softmax_over_model(lay, s, split).to(dtype)
    ctx = torch.einsum("bhst,btl->bshl", prob, c)       # [B,1,H,L]
    if split:
        ctx = all_reduce_(ctx.contiguous(), lay.group("model"))
    if heads is not None:
        ctx = ctx[:, :, heads[0]:heads[0] + heads[1]]
    return torch.einsum("bshl,lhv->bshv", ctx, wbv)


def apply_mla(p: dict, x: torch.Tensor, cfg, *, pos_ids, cache=None,
              write_pos=None) -> tuple[torch.Tensor, dict | None]:
    """MLA block. cache: {"c": [B,Sc,kv_lora], "k_rope": [B,Sc,rope]}
    (decode, written in place at ``write_pos`` and returned) or None.
    Under a mesh the cache is this rank's positions (see the module
    docstring)."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    d, h, lora = cfg.d_model, cfg.n_heads, cfg.kv_lora
    nope, rope, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qk = nope + rope
    if cfg.q_lora:
        wqa, _ = lay.weight(p["wq_a"], ("embed", "q_lora"), (d, cfg.q_lora),
                            dtype)
        wqb, spec = lay.weight(p["wq_b"], ("q_lora", "heads", "head_dim"),
                               (cfg.q_lora, h, qk), dtype)
        tp = lay.on_model(spec, 1)
        qa = rms_norm(torch.einsum("bsd,dl->bsl", x, wqa), p["q_norm"])
        q = torch.einsum("bsl,lhd->bshd", lay.copy_to_model(qa) if tp
                         else qa, wqb)
    else:
        wq, spec = lay.weight(p["wq"], ("embed", "heads", "head_dim"),
                              (d, h, qk), dtype)
        tp = lay.on_model(spec, 1)
        q = torch.einsum("bsd,dhk->bshk", lay.copy_to_model(x) if tp else x,
                         wq)
    wkv_a, _ = lay.weight(p["wkv_a"], ("embed", "kv_lora"), (d, lora + rope),
                          dtype)
    wkv_b, spec_b = lay.weight(p["wkv_b"], ("kv_lora", "heads", "head_dim"),
                               (lora, h, nope + vd), dtype)
    wo, _ = lay.weight(p["wo"], ("heads", "head_dim", "embed"), (h, vd, d),
                       dtype)
    if lay.on_model(spec_b, 1) != tp:
        raise ValueError("wkv_b's heads split differently from the query's")
    heads = lay.model_block(h) if tp else None
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = torch.einsum("bsd,dl->bsl", x, wkv_a)
    c_new = rms_norm(kv_a[..., :lora], p["kv_norm"])
    k_rope_new = kv_a[..., lora:]                       # [B,S,rope]

    cos, sin = rope_cos_sin(pos_ids, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new, cos, sin)       # shared band
    scale = qk ** -0.5

    if cache is None:
        c, k_rope = c_new, k_rope_new
        if tp:      # every rank's heads read the latent and the rope band
            c, k_rope = lay.copy_to_model(c), lay.copy_to_model(k_rope)
        k_nope, v = _project_kv(wkv_b, c, cfg, dtype)   # the rank's heads
        k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3], rope)
        k = torch.cat([k_nope, k_rope_b], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        out = flash_attention(qq, k, v, causal=True, q_offset=0, scale=scale)
        y = torch.einsum("bshk,hkd->bsd", out, wo)
        return (lay.reduce_from_model(y) if tp else y), None

    # decode: this rank's positions [s0, s0 + sl) of the cache
    cc, ck = cache["c"], cache["k_rope"]
    s = c_new.shape[1]
    sl = cc.shape[1]
    s0 = lay.rank("model") * sl
    if s0 <= write_pos < s0 + sl:
        if write_pos + s > s0 + sl:
            raise ValueError("a decode write crosses two ranks' positions")
        cc[:, write_pos - s0:write_pos - s0 + s] = c_new.to(cc.dtype)
        ck[:, write_pos - s0:write_pos - s0 + s] = k_rope_new.to(ck.dtype)
    new_cache = {"c": cc, "k_rope": ck}
    c, k_rope = cc.to(dtype), ck.to(dtype)
    kpos = s0 + torch.arange(sl, dtype=torch.int32, device=x.device)
    if cfg.mla_absorb:
        y = _decode_absorbed(lay, cfg, wkv_b, q_nope, q_rope, c, k_rope,
                             kpos, write_pos, dtype, heads)
    else:
        if tp:      # every head over this rank's positions
            wkv_b = lay.gather_model(wkv_b, 1)
        k_nope, v = _project_kv(wkv_b, c, cfg, dtype)
        k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3], rope)
        k = torch.cat([k_nope, k_rope_b], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        if tp:
            qq = lay.gather_model(qq, 2)
        acc, m, l = flash_attention(qq, k, v, causal=True,
                                    q_offset=write_pos, k_positions=kpos,
                                    chunk=min(1024, sl), scale=scale,
                                    stats=True)
        y = combine_key_blocks(lay, acc, m, l, lay.mesh is not None
                               ).to(dtype)
        if tp:
            y = y[:, :, heads[0]:heads[0] + heads[1]]
    y = torch.einsum("bshk,hkd->bsd", y, wo)
    return (lay.reduce_from_model(y) if tp else y), new_cache
