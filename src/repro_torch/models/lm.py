"""The LM-family model (the port of ``repro.models.lm``).

A model is a list of *segments*, each a block pattern repeated ``repeats``
times, as the reference builds them (``build_segments``). The reference
stacks each segment's weights and scans over them; here every layer keeps
its own weights (``params["seg0"]["blk0"][layer]["mixer"]["wq"]``) and a
Python loop walks the layers. Weights are cast to ``cfg.dtype`` at each use,
as the reference does. The decode cache keeps the reference's stacked
layout, one entry a segment position: ``cache["seg0"]["blk0"]["k"]`` of
``[n, B, S, KVH, D]`` for GQA, ``"c"`` ``[n, B, S, kv_lora]`` and
``"k_rope"`` ``[n, B, S, rope]`` for MLA; ``serve_step`` writes it in place.

Ported kinds: mixers ``gqa`` and ``mla``, MLPs ``mlp`` and ``moe`` (whose
aux losses ``forward`` sums), ``parallel_block``, ``tie_embeddings``,
M-RoPE and ``kv_replicate_to``. The others raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..layers.attention import apply_gqa, init_gqa
from ..layers.mla import apply_mla, init_mla
from ..layers.mlp import apply_mlp, init_mlp
from ..layers.moe import apply_moe, init_moe
from ..layers.norms import rms_norm
from .init import ParamInit, torch_dtype

# kinds of the reference this port does not run yet, with where they are
# ported (ROADMAP queue 1, item 12)
UNPORTED = {
    "rwkv": "layers/rwkv.py (ROADMAP queue 1, item 12c)",
    "rwkv_cm": "layers/rwkv.py (ROADMAP queue 1, item 12c)",
    "rglru": "layers/rglru.py (ROADMAP queue 1, item 12d)",
    "wattn": "the ring-buffer window cache (ROADMAP queue 1, item 12e)",
    "frames": "the frames frontend (ROADMAP queue 1, item 12f)",
    "patch_embeds": "the patch-embedding frontend (ROADMAP queue 1, "
                    "item 12f)",
}


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind!r} is not ported yet: "
                               f"{UNPORTED[kind]}")


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[tuple[str, str], ...]   # ((mixer, mlp), ...) per position
    repeats: int


def build_segments(cfg: ArchConfig) -> list[Segment]:
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if cfg.block_pattern:
        pl = len(cfg.block_pattern)
        reps = cfg.n_layers // pl
        segs = [Segment(tuple(kinds[:pl]), reps)]
        if cfg.n_layers % pl:
            segs.append(Segment(tuple(kinds[reps * pl:]), 1))
        return segs
    segs: list[Segment] = []
    i = 0
    while i < cfg.n_layers:
        j = i
        while j < cfg.n_layers and kinds[j] == kinds[i]:
            j += 1
        segs.append(Segment((kinds[i],), j - i))
        i = j
    return segs


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a kind the port does
    not run yet."""
    if cfg.frontend != "tokens":
        raise _unported(cfg.frontend)
    for seg in build_segments(cfg):
        for mixer, mlp in seg.pattern:
            for kind in (mixer, mlp):
                if kind in UNPORTED:
                    raise _unported(kind)
                if kind not in ("gqa", "mla", "mlp", "moe"):
                    raise ValueError(kind)


# ---------------------------------------------------------------- init ----

def _init_block(col: ParamInit, kind: tuple[str, str], n: int,
                cfg: ArchConfig) -> dict:
    mixer, mlpk = kind
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": col.param((d,), "ones")}
    if mixer == "mla":
        p["mixer"] = init_mla(col, n, cfg)
    else:
        p["mixer"] = init_gqa(col, n, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim)
    if not cfg.parallel_block:
        p["ln2"] = col.param((d,), "ones")
    p["mlp"] = (init_moe(col, n, cfg) if mlpk == "moe"
                else init_mlp(col, n, d, cfg.d_ff))
    return p


def init_params(cfg: ArchConfig, seed: int, device: torch.device) -> dict:
    """Random parameters by the reference's rule (``models.init``), drawn
    on ``device``."""
    check_ported(cfg)
    col = ParamInit(seed, device, cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": col.param((cfg.vocab, cfg.d_model), "normal")}
    for si, seg in enumerate(build_segments(cfg)):
        params[f"seg{si}"] = {
            f"blk{bi}": [_init_block(col, kind, seg.repeats, cfg)
                         for _ in range(seg.repeats)]
            for bi, kind in enumerate(seg.pattern)}
    params["final_norm"] = col.param((cfg.d_model,), "ones")
    if not cfg.tie_embeddings:
        params["lm_head"] = col.param((cfg.d_model, cfg.vocab), "normal")
    return params


# --------------------------------------------------------------- apply ----

def _pos_ids(cfg: ArchConfig, b: int, s: int, offset: int,
             device) -> torch.Tensor:
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)
    pos = pos[None].expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)          # text stub: t=h=w
    return pos


def _apply_block(p, x, cfg, kind, *, pos_ids, cache, write_pos):
    """One layer -> (x, aux); a decode cache is written in place."""
    mixer, mlpk = kind
    aux = None
    h = rms_norm(x, p["ln1"])
    if mixer == "mla":
        y, _ = apply_mla(p["mixer"], h, cfg, pos_ids=pos_ids, cache=cache,
                         write_pos=write_pos)
    else:
        y, _ = apply_gqa(p["mixer"], h, cfg, pos_ids=pos_ids, cache=cache,
                         write_pos=write_pos, causal=cfg.causal)
    if cfg.parallel_block:
        return x + y + apply_mlp(p["mlp"], h, cfg.act), aux
    x = x + y
    h2 = rms_norm(x, p["ln2"])
    if mlpk == "moe":
        out, aux = apply_moe(p["mlp"], h2, cfg)
    else:
        out = apply_mlp(p["mlp"], h2, cfg.act)
    return x + out, aux


class Model:
    """Functional model bound to an ArchConfig: parameters and caches are
    plain nested dicts of tensors passed to each call."""

    def __init__(self, cfg: ArchConfig):
        check_ported(cfg)
        self.cfg = cfg
        self.segments = build_segments(cfg)

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random parameters on ``device`` (default: the CUDA card)."""
        return init_params(self.cfg, seed, resolve_device(device))

    def _run_segments(self, params, x, *, pos_ids, cache, write_pos):
        """-> (x, the summed aux loss in float32)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, seg in enumerate(self.segments):
            for r in range(seg.repeats):
                for bi, kind in enumerate(seg.pattern):
                    cb = None
                    if cache is not None:
                        cb = {name: t[r] for name, t in
                              cache[f"seg{si}"][f"blk{bi}"].items()}
                    x, aux = _apply_block(
                        params[f"seg{si}"][f"blk{bi}"][r], x, self.cfg,
                        kind, pos_ids=pos_ids, cache=cb, write_pos=write_pos)
                    if aux is not None:
                        aux_total = aux_total + aux
        return x, aux_total

    def forward(self, params, batch: dict) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """-> (final hidden [B,S,d] in cfg.dtype, aux loss)."""
        if "patch_embeds" in batch:
            raise _unported("patch_embeds")
        dtype = torch_dtype(self.cfg.dtype)
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()].to(dtype)
        b, s = x.shape[:2]
        pos_ids = _pos_ids(self.cfg, b, s, 0, x.device)
        x, aux = self._run_segments(params, x, pos_ids=pos_ids, cache=None,
                                    write_pos=None)
        return rms_norm(x, params["final_norm"]), aux

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return torch.matmul(x, head.to(x.dtype))

    def serve_step(self, params, cache, tokens: torch.Tensor, pos: int
                   ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens [B,1] at position ``pos`` ->
        (logits [B,V], the cache, written in place)."""
        dtype = torch_dtype(self.cfg.dtype)
        x = params["embed"][tokens.long()].to(dtype)
        pos_ids = _pos_ids(self.cfg, x.shape[0], 1, int(pos), x.device)
        x, _ = self._run_segments(params, x, pos_ids=pos_ids, cache=cache,
                                  write_pos=int(pos))
        x = rms_norm(x, params["final_norm"])
        return self.logits(params, x)[:, 0], cache


# ---------------------------------------------------------------- cache ----

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device=None) -> dict:
    """Decode cache (stacked leading dim = segment repeats) on ``device``
    (default: the CUDA card)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    kvh = (cfg.kv_replicate_to
           if cfg.kv_replicate_to > cfg.n_kv_heads
           and cfg.kv_replicate_to % cfg.n_kv_heads == 0
           else cfg.n_kv_heads)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: dict[str, Any] = {}
    for si, seg in enumerate(build_segments(cfg)):
        n = seg.repeats
        cache[f"seg{si}"] = {
            f"blk{bi}": ({"c": zeros(n, batch, max_seq, cfg.kv_lora),
                          "k_rope": zeros(n, batch, max_seq,
                                          cfg.rope_head_dim)}
                         if mixer == "mla" else
                         {"k": zeros(n, batch, max_seq, kvh, hd),
                          "v": zeros(n, batch, max_seq, kvh, hd)})
            for bi, (mixer, _) in enumerate(seg.pattern)}
    return cache
