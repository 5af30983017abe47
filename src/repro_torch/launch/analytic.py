"""Analytic (napkin-math) FLOP and memory-traffic model of a cell, the
port's own copy of ``repro.launch.analytic`` (pure Python), kept so that
the port's dry-run records carry the same ``analytic`` row as the
reference's and the two compare.

Conventions (the reference's):
  * matmul = 2 flops/MAC; backward = 2x forward (so train = 3x forward);
  * MODEL_FLOPS counts *useful* compute: active params (MoE: top-k + shared)
    excluding the embedding gather, plus attention score/value flops;
  * causal full attention: S^2/2 key positions per query; sliding window:
    min(S, W) per query; decode: full context per step;
  * RWKV6 WKV: ~8 flops per (token, channel, head-dim) for the state
    update + readout; RG-LRU element-wise scan is negligible next to its
    projections (which live in the param count).

``analytic_memory_bytes`` is the reference's coarse per-device traffic
model "assuming TPU-grade fusion": a flash kernel keeps the score chain in
on-chip memory, and elementwise chains fuse into the products' epilogues,
so only the parameters, about ten saved tensors a layer and the KV stream
reach HBM. The port on the H100 fuses only inside its kernels (K5's
scores stay on chip; the rest of a layer runs as separate PyTorch ops), so
this is the lower band; the dry run's ``bytes`` (every op's reads and
writes, unfused) is the upper band.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig


def _attn_flops_per_layer(cfg: ArchConfig, kind: str, s: int, b: int,
                          decode: bool) -> float:
    h = cfg.n_heads
    if kind == "mla":
        dk = cfg.nope_head_dim + cfg.rope_head_dim
        dv = cfg.v_head_dim
    else:
        dk = dv = cfg.resolved_head_dim
    if decode:
        ctx = min(s, cfg.window) if kind == "wattn" else s
        return 2.0 * b * h * ctx * (dk + dv)
    ctx = min(s, cfg.window) if kind == "wattn" else s
    per_q = ctx / 2 if ctx == s else ctx          # causal triangle vs band
    if not cfg.causal:
        per_q = ctx
    return 2.0 * b * s * per_q * h * (dk + dv)


def _wkv_flops_per_layer(cfg: ArchConfig, s: int, b: int) -> float:
    return 8.0 * b * s * cfg.d_model * cfg.rwkv_head_size


def analytic_memory_bytes(cfg: ArchConfig, shape: ShapeConfig, *,
                          n_data: int = 16, n_model: int = 16) -> float:
    """Per-device HBM traffic per step assuming TPU-grade fusion (a Pallas
    flash kernel keeps score chains in VMEM; elementwise chains fuse into
    matmul epilogues). This is the *fused lower-band* partner to the HLO
    bytes-accessed upper band (which CPU-XLA's non-fusion inflates ~5-10x
    on attention-heavy cells) — both are reported in §Roofline.

    Model (documented coarse accounting):
      params: train 32 B/param/step (f32 p/m/v read+write + f32 grad r/w)
              else 2 B (one bf16 read; FSDP gather cost sits in the
              collective term); params are model-sharded /n_model (FSDP
              re-gather means each device still touches its model slice).
      acts:   tokens/device x d_model x 2B x n_layers x C with C = 30 for
              train (fwd + bwd + remat recompute of ~10 major per-layer
              tensors), 10 for prefill, 10 for decode.
      attn:   K/V re-read once per 1024-query chunk (flash kv streaming);
              decode reads the whole cache slice once per step.
      moe:    dispatch buffers (k+shared)x d x 2B x tokens x L_moe x
              (6 train / 2 else).
    """
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    d = cfg.d_model
    tokens_dev = (b if decode else b * s) / n_data
    l = cfg.n_layers

    n_params = cfg.n_params()
    param_bytes = (32.0 if shape.kind == "train" else 2.0)
    traffic = n_params / n_model * param_bytes

    c = 30.0 if shape.kind == "train" else 10.0
    traffic += tokens_dev * d * 2.0 * l * c

    # attention KV streaming
    n_attn = sum(1 for i in range(l) if cfg.layer_kind(i)[0] in
                 ("gqa", "wattn", "mla"))
    if n_attn:
        if cfg.attn_type == "mla":
            kv_row = (cfg.kv_lora + cfg.rope_head_dim) * 2.0
        else:
            kv_row = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2.0
        if decode:
            ctx = min(s, cfg.window) if cfg.window else s
            traffic += (b / n_data) * ctx * kv_row * n_attn
        else:
            reread = max(s // 1024, 1)
            ctx = min(s, cfg.window) if cfg.window else s
            traffic += (b / n_data) * ctx * kv_row * reread * n_attn * \
                (3.0 if shape.kind == "train" else 1.0)

    if cfg.n_experts:
        l_moe = l - cfg.first_dense
        traffic += (tokens_dev * (cfg.top_k + 1) * d * 2.0 * l_moe
                    * (6.0 if shape.kind == "train" else 2.0))
    return traffic


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    tokens = b if decode else b * s
    n_eff = cfg.active_params() - cfg.vocab * cfg.d_model   # drop embed table
    mult = 6.0 if shape.kind == "train" else 2.0
    total = mult * n_eff * tokens

    attn_mult = 3.0 if shape.kind == "train" else 1.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)[0]
        if kind in ("gqa", "wattn", "mla"):
            total += attn_mult * _attn_flops_per_layer(cfg, kind, s, b,
                                                       decode)
        elif kind == "rwkv":
            st = 1 if decode else s
            total += attn_mult * _wkv_flops_per_layer(cfg, st, b)
    return {"model_flops": total, "n_eff": n_eff, "tokens": tokens}
