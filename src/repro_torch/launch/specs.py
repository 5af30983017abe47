"""Stand-ins for every model input of a cell, allocating nothing (the port
of ``repro.launch.specs``).

``input_specs(cfg, shape, mesh)`` gives the argument tree each step
function runs on: a ``TensorSpec`` a leaf, with the input's global shape
and dtype (the reference's ``ShapeDtypeStruct``), this rank's block as a
tensor on ``torch.device("meta")`` (``logical_sharding(...).shard_shape``)
and the ``NamedSharding`` that ``parallel.sharding`` gives it. A mesh is a
``DeviceMesh`` or a shape-only ``MeshShape``. Modality frontends are stubs
as in the reference: ``frames`` configs take precomputed frame embeddings,
vlm configs token ids and 256 precomputed patch embeddings a sample (text
M-RoPE ids).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.lm import CACHE_AXES, cache_leaf_axes, init_cache
from ..parallel.sharding import (NamedSharding, logical_sharding, mesh_dims,
                                 set_mesh_rules)

_CACHE_AXES = CACHE_AXES


class TensorSpec(NamedTuple):
    """One input: its global shape and dtype, this rank's block (a meta
    tensor) and its sharding (None without a mesh)."""
    shape: tuple
    dtype: torch.dtype
    local: torch.Tensor
    sharding: NamedSharding | None


def _spec(shape, dtype, axes, mesh, rules=None) -> TensorSpec:
    sh = logical_sharding(axes, shape, mesh, rules) if mesh is not None \
        else None
    local = sh.shard_shape(shape) if sh is not None else tuple(shape)
    return TensorSpec(tuple(shape), dtype,
                      torch.empty(local, dtype=dtype, device="meta"), sh)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, rules=None, *,
                labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.frontend == "frames":
        out["frames"] = _spec((b, s, cfg.d_model), torch.bfloat16,
                              ("act_batch", "act_seq", "act_embed"), mesh,
                              rules)
    else:
        out["tokens"] = _spec((b, s), torch.int32, ("act_batch", "act_seq"),
                              mesh, rules)
        if cfg.family == "vlm" and s >= 256:
            # vision stub: 256 precomputed patch embeddings per sample
            out["patch_embeds"] = _spec((b, 256, cfg.d_model),
                                        torch.bfloat16,
                                        ("act_batch", None, "act_embed"),
                                        mesh, rules)
    if labels:
        out["labels"] = _spec((b, s), torch.int32, ("act_batch", "act_seq"),
                              mesh, rules)
    return out


def cache_axes(cache) -> dict:
    """Logical axes tree matching an ``init_cache`` tree (by leaf name)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (_CACHE_AXES[k] if not isinstance(v, dict)
                        else walk(v)) for k, v in node.items()}
        raise TypeError(node)
    return walk(cache)


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, rules=None):
    """The decode cache's ``TensorSpec`` tree: k and v split by kv heads
    where they divide ``model``, else by positions (``cache_leaf_axes``)."""
    with set_mesh_rules(None):
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
    n_model = mesh_dims(mesh).get("model", 1) if mesh is not None else 1

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    _spec(v.shape, v.dtype,
                          cache_leaf_axes(k, v.shape, n_model), mesh, rules))
                for k, v in node.items()}
    return walk(cache)


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, rules=None):
    """(cache, tokens, pos) argument specs for ``serve_step``."""
    b = shape.global_batch
    cache = cache_specs(cfg, shape, mesh, rules)
    tokens = _spec((b, 1), torch.int32, ("act_batch", None), mesh, rules)
    pos = _spec((), torch.int32, (), mesh, rules)
    return cache, tokens, pos


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None, rules=None):
    """Every model input of the cell: train -> batch dict, prefill -> batch
    dict, decode -> (cache, tokens, pos)."""
    if shape.kind == "train":
        return batch_specs(cfg, shape, mesh, rules, labels=True)
    if shape.kind == "prefill":
        return batch_specs(cfg, shape, mesh, rules, labels=False)
    return decode_specs(cfg, shape, mesh, rules)


def local(tree):
    """``tree`` with each ``TensorSpec`` replaced by its meta block."""
    if isinstance(tree, TensorSpec):
        return tree.local
    if isinstance(tree, dict):
        return {k: local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local(v) for v in tree)
    return tree
