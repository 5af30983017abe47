"""The LM-family model (the port of ``repro.models.lm``).

A model is a list of *segments*, each a block pattern repeated ``repeats``
times, as the reference builds them (``build_segments``). The reference
stacks each segment's weights and scans over them; here every layer keeps
its own weights (``params["seg0"]["blk0"][layer]["mixer"]["wq"]``) and a
Python loop walks the layers. Weights are cast to ``cfg.dtype`` at each use,
as the reference does. The decode cache keeps the reference's stacked
layout, one entry a segment position, ``[n, B, ...]``:

* ``gqa``: ``"k"``, ``"v"`` ``[n, B, S, KVH, D]``;
* ``mla``: ``"c"`` ``[n, B, S, kv_lora]``, ``"k_rope"`` ``[n, B, S, rope]``;
* ``wattn``: a ring buffer of the last ``window`` positions, ``"k"``,
  ``"v"`` ``[n, B, window, n_kv_heads, D]`` and the absolute position of
  each ring slot, ``"kpos"`` ``[n, window]`` (``-10**9`` where unwritten),
  which every batch row shares, as in the reference;
* ``rwkv``: ``{"time": {"shift", "wkv"}, "channel_shift"}`` float32;
* ``rglru``: ``"conv"`` ``[n, B, CW-1, W]`` and ``"h"`` ``[n, B, W]``
  float32.

``serve_step`` writes it in place: K/V rows and ring slots are written at
the step's position, recurrent state is replaced by ``copy_`` into the
cache's storage, so the cache it returns is the one it was given.

Every kind of the reference runs: mixers ``gqa``, ``mla``, ``wattn``,
``rwkv`` and ``rglru``, MLPs ``mlp``, ``moe`` (whose aux losses ``forward``
sums) and ``rwkv_cm``, ``parallel_block``, ``tie_embeddings``, M-RoPE,
``kv_replicate_to``, and both frontends: ``frames`` (precomputed frame
embeddings ``[B, S, d]`` through ``in_proj``, hubert) and ``patch_embeds``
(precomputed patch embeddings ``[B, P, d]`` in place of the first P
positions' token embeddings, qwen2-vl; M-RoPE ids stay text-mode).

``forward`` is also the training forward: ``cfg.remat`` recomputes each
layer in the backward pass (``_remat``), as the reference's
``jax.checkpoint`` around each segment body does.

Under a ``DeviceMesh`` installed by ``parallel.set_mesh_rules`` the
parameters, inputs and cache are this rank's blocks under the active rules
(the production layout, ``parallel.collectives``): the vocab-parallel
embedding and LM head (logits gathered over ``model``), FSDP's gather of
each weight at use, and tensor parallelism in every mixer and MLP: GQA,
MLA, RWKV6's time and channel mixes, the RG-LRU and the windowed attention
(its decode ring split by kv heads where they divide ``model``, else by
ring slots), the MoE's expert-parallel and gspmd bodies, and
``init_cache`` at the rank's shapes for every family.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..layers.attention import (apply_gqa, cache_kv_heads,
                                combine_key_blocks, flash_attention,
                                gqa_projections, init_gqa)
from ..layers.grad import taking_grad
from ..layers.mla import apply_mla, init_mla
from ..layers.mlp import apply_mlp, init_mlp
from ..layers.moe import apply_moe, init_moe
from ..layers.norms import rms_norm
from ..layers.rglru import apply_rglru, init_rglru
from ..layers.rwkv import (apply_rwkv_channel, apply_rwkv_time,
                           init_rwkv_channel, init_rwkv_time)
from .init import ParamInit, torch_dtype

MIXERS = ("gqa", "mla", "wattn", "rwkv", "rglru")
MLPS = ("mlp", "moe", "rwkv_cm")
FRONTENDS = ("tokens", "frames")
REMAT = ("none", "dots", "full")
EMPTY_POS = -10**9          # a ring slot no position has been written to


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
    """Raise ``ValueError`` for a config with a kind the reference does not
    have either (every config of the registry passes)."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    for seg in build_segments(cfg):
        for mixer, mlp in seg.pattern:
            if mixer not in MIXERS or mlp not in MLPS:
                raise ValueError((mixer, mlp))


# ---------------------------------------------------------------- init ----

def _init_block(col: ParamInit, kind: tuple[str, str], n: int,
                cfg: ArchConfig) -> dict:
    mixer, mlpk = kind
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": col.param((d,), "ones", axes=("norm",))}
    if mixer == "mla":
        p["mixer"] = init_mla(col, n, cfg)
    elif mixer == "rwkv":
        p["mixer"] = init_rwkv_time(col, n, cfg)
    elif mixer == "rglru":
        p["mixer"] = init_rglru(col, n, cfg)
    else:
        p["mixer"] = init_gqa(col, n, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim)
    if not cfg.parallel_block:
        p["ln2"] = col.param((d,), "ones", axes=("norm",))
    if mlpk == "moe":
        p["mlp"] = init_moe(col, n, cfg)
    elif mlpk == "rwkv_cm":
        p["mlp"] = init_rwkv_channel(col, n, cfg)
    else:
        p["mlp"] = init_mlp(col, n, d, cfg.d_ff)
    return p


def init_params(cfg: ArchConfig, seed: int, device: torch.device
                ) -> tuple[dict, dict[str, tuple]]:
    """(random parameters by the reference's rule (``models.init``), drawn
    on ``device``; their logical axes by path, ``ParamInit.axes_of``)."""
    check_ported(cfg)
    col = ParamInit(seed, device, cfg.param_dtype)
    params: dict[str, Any] = {}
    if cfg.frontend == "frames":
        params["in_proj"] = col.param((cfg.d_model, cfg.d_model), "scaled",
                                      axes=("embed", None))
    params["embed"] = col.param((cfg.vocab, cfg.d_model), "normal",
                                axes=("vocab", "embed"))
    for si, seg in enumerate(build_segments(cfg)):
        params[f"seg{si}"] = {
            f"blk{bi}": [_init_block(col, kind, seg.repeats, cfg)
                         for _ in range(seg.repeats)]
            for bi, kind in enumerate(seg.pattern)}
    params["final_norm"] = col.param((cfg.d_model,), "ones", axes=("norm",))
    if not cfg.tie_embeddings:
        params["lm_head"] = col.param((cfg.d_model, cfg.vocab), "normal",
                                      axes=("embed", "vocab"))
    return params, col.axes_of(params)


# --------------------------------------------------------------- apply ----

def _pos_ids(cfg: ArchConfig, b: int, s: int, offset: int,
             device) -> torch.Tensor:
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)
    pos = pos[None].expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)          # text stub: t=h=w
    return pos


def _write_state(cache: dict, state: dict) -> None:
    """Copy a layer's new recurrent state into its cache views (the
    cache's storage), entry by entry."""
    for name, t in state.items():
        if isinstance(t, dict):
            _write_state(cache[name], t)
        else:
            cache[name].copy_(t)


def _apply_ring_block(p, x, cfg, *, pos_ids, cache, write_pos):
    """``wattn`` decode through the ring buffer
    (``src/repro/models/lm.py:137-164``): this step's K/V go to ring slot
    ``write_pos % window``, which takes ``write_pos`` as its position, and
    the query attends to the ring through its explicit key positions. No
    M-RoPE and no KV replication on this branch, as in the reference.

    Under a mesh (``parallel.set_mesh_rules``) the query heads split over
    ``model`` as in ``apply_gqa``, and the ring's ``k``/``v`` are the
    rank's block (``cache_leaf_axes``): its kv heads where they divide
    ``model``, each rank attending with the query heads that read them;
    else its ring slots (context parallel over the ring), each rank
    attending over its slots with every query head, the partial softmax
    states joined by ``attention.combine_key_blocks``. The slot is written
    on the rank that holds it; every rank writes the whole ``kpos``."""
    from ..parallel.collectives import layout
    lay = layout()
    dtype = x.dtype
    window, h, kv = cfg.window, cfg.n_heads, cfg.n_kv_heads
    q, k, v, wo, q_tp, kv_tp = gqa_projections(lay, p, x, cfg, pos_ids,
                                               mrope=False)
    slot = write_pos % window
    s = k.shape[1]
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    kpos[slot] = write_pos
    n = lay.size("model")
    h0, hl = lay.model_block(h) if q_tp else (0, h)
    if kv % n == 0:                     # the ring split by kv heads
        c0, cl = lay.model_block(kv)
        if not kv_tp:                   # k, v computed whole: this block
            k, v = k[:, :, c0:c0 + cl], v[:, :, c0:c0 + cl]
        ck[:, slot:slot + s] = k.to(ck.dtype)
        cv[:, slot:slot + s] = v.to(cv.dtype)
        g = h // kv
        qa, ql = c0 * g, cl * g         # the query heads that read them
        if not q_tp:
            q, wo = q[:, :, qa:qa + ql], wo[qa:qa + ql]
        out = flash_attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                              q_offset=write_pos, window=window,
                              k_positions=kpos, chunk=min(1024, window))
        return lay.reduce_from_model(
            torch.einsum("bshk,hkd->bsd", out, wo))
    # context parallel over the ring: this rank's slots [s0, s0 + sl)
    if kv_tp:
        raise ValueError(f"kv heads split over model with a ring of {kv} "
                         "kv heads split by slots")
    sl = ck.shape[1]
    s0 = lay.rank("model") * sl
    if s0 <= slot < s0 + sl:
        if slot + s > s0 + sl:
            raise ValueError("a decode write crosses two ranks' ring slots")
        ck[:, slot - s0:slot - s0 + s] = k.to(ck.dtype)
        cv[:, slot - s0:slot - s0 + s] = v.to(cv.dtype)
    if q_tp:
        q = lay.gather_model(q, 2)
    acc, m, l = flash_attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                                q_offset=write_pos, window=window,
                                k_positions=kpos[s0:s0 + sl],
                                chunk=min(1024, sl), stats=True)
    out = combine_key_blocks(lay, acc, m, l, True).to(dtype)
    if q_tp:
        y = torch.einsum("bshk,hkd->bsd", out[:, :, h0:h0 + hl], wo)
        return lay.reduce_from_model(y)
    return torch.einsum("bshk,hkd->bsd", out, wo)


def _apply_block(p, x, cfg, kind, *, pos_ids, cache, write_pos):
    """One layer -> (x, aux); a decode cache is written in place
    (``src/repro/models/lm.py:167-204``)."""
    mixer, mlpk = kind
    aux = None
    h = rms_norm(x, p["ln1"])
    if mixer == "mla":
        y, _ = apply_mla(p["mixer"], h, cfg, pos_ids=pos_ids, cache=cache,
                         write_pos=write_pos)
    elif mixer == "rwkv":
        y, st = apply_rwkv_time(p["mixer"], h, cfg, state=(
            None if cache is None else cache["time"]))
        if cache is not None:
            _write_state(cache["time"], st)
    elif mixer == "rglru":
        y, st = apply_rglru(p["mixer"], h, cfg, state=cache)
        if cache is not None:
            _write_state(cache, st)
    elif mixer == "wattn" and cache is not None:
        y = _apply_ring_block(p["mixer"], h, cfg, pos_ids=pos_ids,
                              cache=cache, write_pos=write_pos)
    else:
        y, _ = apply_gqa(p["mixer"], h, cfg, pos_ids=pos_ids, cache=cache,
                         write_pos=write_pos, causal=cfg.causal,
                         window=cfg.window if mixer == "wattn" else 0)
    if cfg.parallel_block:
        return x + y + apply_mlp(p["mlp"], h, cfg.act, cfg.d_ff), aux
    x = x + y
    h2 = rms_norm(x, p["ln2"])
    if mlpk == "moe":
        out, aux = apply_moe(p["mlp"], h2, cfg)
    elif mlpk == "rwkv_cm":
        out, st = apply_rwkv_channel(p["mlp"], h2, state=(
            None if cache is None else {"shift": cache["channel_shift"]}),
            d_ff=cfg.d_ff)
        if cache is not None:
            cache["channel_shift"].copy_(st["shift"])
    else:
        out = apply_mlp(p["mlp"], h2, cfg.act, cfg.d_ff)
    return x + out, aux


def _patch(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """``x`` [B,S,d] with ``pe`` written over its corner ``[:Bp, :P]``,
    the reference's ``dynamic_update_slice(x, pe, (0, 0, 0))``, which
    refuses an update larger than ``x``."""
    bp, p = pe.shape[:2]
    if pe.dim() != 3 or bp > x.shape[0] or p > x.shape[1] \
            or pe.shape[2] != x.shape[2]:
        raise ValueError(f"patch embeddings {tuple(pe.shape)} do not fit "
                         f"in the embeddings {tuple(x.shape)}")
    head = torch.cat([pe, x[:bp, p:]], dim=1)
    return torch.cat([head, x[bp:]], dim=0) if bp < x.shape[0] else head


def saves_product(op, args) -> bool:
    """Remat ``"dots"``'s rule: an ``mm`` or ``addmm``, or a ``bmm`` whose
    batch extent is 1, which is how ``torch.einsum`` lowers a product
    without batch dims (``"bsd,dhk->bshk"``). The counterpart of the
    reference's ``dots_with_no_batch_dims_saveable``: the attention
    scores, the MoE experts' products and every other product with a batch
    dim are recomputed. A batched product whose batch dims all have extent
    1 (batch 1 with one KV head) is saved too: the policy sees the
    lowered op only."""
    ops = torch.ops.aten
    if op in (ops.mm.default, ops.addmm.default):
        return True
    return op is ops.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if saves_product(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` recomputed in the backward pass (the reference's ``_remat``,
    ``src/repro/models/lm.py:207-214``). ``"full"`` saves only the layer's
    inputs (``torch.utils.checkpoint``); ``"dots"`` also saves the
    products that ``saves_product`` names, through selective
    checkpointing. Either way the gradients are the same function; only
    what is kept between the passes differs. The recompute runs under the
    mesh and rules of the forward (``parallel.sharding.bound``)."""
    if mode == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    from ..parallel.sharding import bound
    fn = bound(fn)
    if mode == "full":
        return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False, **kw)

    def contexts():
        return create_selective_checkpoint_contexts(_dots_policy)
    return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                       context_fn=contexts, **kw)


def _layer_view(entry: dict, r: int) -> dict:
    """Layer ``r``'s views of a stacked cache entry, nested entries
    included."""
    return {name: (_layer_view(t, r) if isinstance(t, dict) else t[r])
            for name, t in entry.items()}


class Model:
    """Functional model bound to an ArchConfig: parameters and caches are
    plain nested dicts of tensors passed to each call."""

    def __init__(self, cfg: ArchConfig):
        check_ported(cfg)
        self.cfg = cfg
        self.segments = build_segments(cfg)
        self._plan = None           # (a Layout, its tree_shardings)

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random parameters on ``device`` (default: the CUDA card); on
        ``"meta"`` their shapes alone, allocating nothing."""
        return self.init_with_axes(seed, device=device)[0]

    def init_with_axes(self, seed: int = 0, *, device=None
                       ) -> tuple[dict, dict[str, tuple]]:
        """(``init``'s parameters, their logical axes by path: the
        reference's ``Model.init`` pair, for ``parallel.tree_shardings``)."""
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        return init_params(self.cfg, seed, dev)

    def _run_segments(self, params, x, *, pos_ids, cache, write_pos):
        """-> (x, the summed aux loss in float32). A forward without a
        cache recomputes each layer under ``cfg.remat`` when a gradient is
        taken (the reference checkpoints each segment body: one layer, or
        one pattern of Griffin's)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        cfg = self.cfg
        for si, seg in enumerate(self.segments):
            for r in range(seg.repeats):
                cbs = [None if cache is None else
                       _layer_view(cache[f"seg{si}"][f"blk{bi}"], r)
                       for bi in range(len(seg.pattern))]

                def body(x, ps, _seg=seg, _cbs=cbs):
                    auxes = []
                    for bi, kind in enumerate(_seg.pattern):
                        x, aux = _apply_block(
                            ps[bi], x, cfg, kind, pos_ids=pos_ids,
                            cache=_cbs[bi], write_pos=write_pos)
                        if aux is not None:
                            auxes.append(aux)
                    return x, auxes

                ps = [params[f"seg{si}"][f"blk{bi}"][r]
                      for bi in range(len(seg.pattern))]
                if cache is None and taking_grad(x, ps):
                    body = _remat(body, cfg.remat)
                x, auxes = body(x, ps)
                for aux in auxes:
                    aux_total = aux_total + aux
        return x, aux_total

    def forward(self, params, batch: dict) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """-> (final hidden [B,S,d] in cfg.dtype, aux loss). ``batch``
        holds ``"tokens"`` [B,S] (``"patch_embeds"`` [B,P,d] replacing the
        first P positions' embeddings), or ``"frames"`` [B,S,d] for a
        ``frames`` config (``src/repro/models/lm.py:267-283``)."""
        dtype = torch_dtype(self.cfg.dtype)
        lay = self.active_layout()
        if self.cfg.frontend == "frames":
            d = self.cfg.d_model
            w, _ = lay.weight(params["in_proj"], ("embed", None), (d, d),
                              dtype)
            x = torch.matmul(batch["frames"].to(dtype), w)
        else:
            x = self._embed(lay, params, batch["tokens"], dtype)
            if "patch_embeds" in batch:
                x = _patch(x, batch["patch_embeds"].to(dtype))
        b, s = x.shape[:2]
        pos_ids = _pos_ids(self.cfg, b, s, 0, x.device)
        x, aux = self._run_segments(params, x, pos_ids=pos_ids, cache=None,
                                    write_pos=None)
        return rms_norm(x, params["final_norm"]), aux

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """x [..., d] -> the logits over the whole vocab; under a mesh each
        rank projects its vocab block and the blocks are gathered over
        ``model``."""
        lay = self.active_layout()
        head, split = self.head(lay, params, x.dtype)
        if not split:
            return torch.matmul(x, head)
        return lay.gather_model(torch.matmul(lay.copy_to_model(x), head),
                                x.dim() - 1)

    def head(self, lay, params, dtype) -> tuple[torch.Tensor, bool]:
        """(this rank's ``[d, V or V/n]`` LM head in ``dtype``, FSDP's dims
        gathered; whether its vocab is split over ``model``)."""
        v, d = self.cfg.vocab, self.cfg.d_model
        if self.cfg.tie_embeddings:
            w, spec = lay.weight(params["embed"], ("vocab", "embed"), (v, d),
                                 dtype)
            return w.T, lay.on_model(spec, 0)
        w, spec = lay.weight(params["lm_head"], ("embed", "vocab"), (d, v),
                             dtype)
        return w, lay.on_model(spec, 1)

    def _embed(self, lay, params, tokens: torch.Tensor, dtype
               ) -> torch.Tensor:
        """Token embeddings in ``dtype``. Under a mesh whose rules split the
        vocab over ``model`` (the vocab-parallel embedding): each rank
        looks up the tokens in its block, zeroes the others, and the rows
        are summed over ``model``; FSDP's ``embed`` dim is gathered first."""
        table = params["embed"]
        full = (self.cfg.vocab, self.cfg.d_model)
        spec = lay.check(table, ("vocab", "embed"), full)
        if lay.names(spec, 1):
            table, _ = lay.weight(table, ("vocab", "embed"), full, dtype)
        if not lay.on_model(spec, 0):
            return table[tokens.long()].to(dtype)
        v0, vl = lay.model_block(self.cfg.vocab)
        idx = tokens.long() - v0
        inside = (idx >= 0) & (idx < vl)
        rows = table[idx.clamp(0, vl - 1)].to(dtype)
        rows = torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=dtype, device=rows.device))
        return lay.reduce_from_model(rows)

    def active_layout(self):
        """The active ``parallel.collectives.Layout`` (``WHOLE`` without a
        ``DeviceMesh``; under one, ``shardings`` checks the families)."""
        from ..parallel.collectives import layout
        lay = layout()
        if lay.mesh is not None:
            self.shardings(lay)
        return lay

    def leaf_specs(self, lay) -> list | None:
        """Each parameter leaf's spec under ``lay``, in ``leaves`` order
        (None for ``WHOLE``)."""
        if lay.mesh is None:
            return None
        from ..optim.adamw import leaves
        return [s.spec for s in leaves(self.shardings(lay))]

    def shardings(self, lay) -> dict:
        """``parallel.tree_shardings`` of the full parameter tree under
        ``lay``'s mesh and rules (from a ``meta`` init, kept for the last
        layout)."""
        if self._plan is None or self._plan[0] is not lay:
            from ..parallel.sharding import tree_shardings
            meta, axes = self.init_with_axes(device="meta")
            self._plan = (lay, tree_shardings(meta, axes, lay.mesh,
                                              lay.rules))
        return self._plan[1]

    def serve_step(self, params, cache, tokens: torch.Tensor, pos: int
                   ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens [B,1] at position ``pos`` ->
        (logits [B,V], the cache, written in place)."""
        dtype = torch_dtype(self.cfg.dtype)
        x = self._embed(self.active_layout(), params, tokens, dtype)
        pos_ids = _pos_ids(self.cfg, x.shape[0], 1, int(pos), x.device)
        x, _ = self._run_segments(params, x, pos_ids=pos_ids, cache=cache,
                                  write_pos=int(pos))
        x = rms_norm(x, params["final_norm"])
        return self.logits(params, x)[:, 0], cache


# ---------------------------------------------------------------- cache ----

# each cache entry's logical axes (the reference's ``launch/specs.py``
# ``_CACHE_AXES``); ``cache_leaf_axes`` picks k's and v's split
CACHE_AXES = {
    "k": (None, "act_batch", "act_kv_seq", "act_kv_heads", None),
    "v": (None, "act_batch", "act_kv_seq", "act_kv_heads", None),
    "kpos": (None, None),
    "c": (None, "act_batch", "act_kv_seq", None),
    "k_rope": (None, "act_batch", "act_kv_seq", None),
    "shift": (None, "act_batch", None),
    "channel_shift": (None, "act_batch", None),
    "wkv": (None, "act_batch", "act_heads", None, None),
    "conv": (None, "act_batch", None, "rnn"),
    "h": (None, "act_batch", "rnn"),
}


def cache_leaf_axes(key: str, shape, n_model: int) -> tuple:
    """A cache entry's axes: a ``[n, B, S, KVH, D]`` k or v splits its kv
    heads over ``model`` where they divide it (attention is then local to
    the rank), else its positions (context parallel)."""
    if key in ("k", "v") and len(shape) == 5:
        if shape[3] % n_model == 0:
            return (None, "act_batch", None, "act_kv_heads", None)
        return (None, "act_batch", "act_kv_seq", None, None)
    return CACHE_AXES[key]


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device=None) -> dict:
    """Decode cache (stacked leading dim = segment repeats) on ``device``
    (default: the CUDA card; ``"meta"`` for shapes alone), the reference's
    entries (``src/repro/models/lm.py:315-362``). Under a ``DeviceMesh``
    (``parallel.set_mesh_rules``) each entry is this rank's block of the
    ``batch``-row cache, split by ``cache_leaf_axes``."""
    from ..parallel.collectives import layout
    from ..parallel.sharding import logical_sharding
    check_ported(cfg)
    lay = layout()
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    dtype = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    kvh = cache_kv_heads(cfg)

    def make(key, shape, dt=dtype, fill=0):
        if lay.mesh is not None:
            axes = cache_leaf_axes(key, shape, lay.size("model"))
            sh = logical_sharding(axes, shape, lay.mesh, lay.rules)
            positional = (key in ("k", "v") and len(shape) == 5) or key in (
                "c", "k_rope")
            if positional and lay.size("model") > 1 and not any(
                    sh.spec[2:4] if len(sh.spec) > 2 else ()):
                raise ValueError(f"a {shape} {key} cache splits neither "
                                 "its heads nor its positions over "
                                 f"{lay.size('model')} model ranks")
            shape = sh.shard_shape(shape)
        return torch.full(shape, fill, dtype=dt, device=device)

    def entry(n: int, mixer: str, mlpk: str) -> dict:
        if mixer == "mla":
            e = {"c": make("c", (n, batch, max_seq, cfg.kv_lora)),
                 "k_rope": make("k_rope", (n, batch, max_seq,
                                           cfg.rope_head_dim))}
        elif mixer == "wattn":
            # the window's own KV heads: kv_replicate_to widens only gqa
            w = cfg.window
            e = {"k": make("k", (n, batch, w, cfg.n_kv_heads, hd)),
                 "v": make("v", (n, batch, w, cfg.n_kv_heads, hd)),
                 "kpos": make("kpos", (n, w), torch.int32, EMPTY_POS)}
        elif mixer == "rwkv":
            hs = cfg.rwkv_head_size
            e = {"time": {
                "shift": make("shift", (n, batch, cfg.d_model),
                              torch.float32),
                "wkv": make("wkv", (n, batch, cfg.d_model // hs, hs, hs),
                            torch.float32)}}
        elif mixer == "rglru":
            e = {"conv": make("conv", (n, batch, cfg.conv_width - 1,
                                       cfg.rnn_width), torch.float32),
                 "h": make("h", (n, batch, cfg.rnn_width), torch.float32)}
        else:
            e = {"k": make("k", (n, batch, max_seq, kvh, hd)),
                 "v": make("v", (n, batch, max_seq, kvh, hd))}
        if mlpk == "rwkv_cm":
            e["channel_shift"] = make("channel_shift", (n, batch, cfg.d_model),
                                      torch.float32)
        return e

    return {f"seg{si}": {f"blk{bi}": entry(seg.repeats, mixer, mlpk)
                         for bi, (mixer, mlpk) in enumerate(seg.pattern)}
            for si, seg in enumerate(build_segments(cfg))}
