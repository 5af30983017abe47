"""Carry state across from plain arrays: a port ``PLEX`` or ``Snapshot``,
and the LM's parameters and training state, both ways
(``lm_params_from_arrays`` / ``lm_arrays_from_params``,
``train_state_from_arrays`` / ``train_state_to_arrays``: the reference's
segment-stacked layout, in which checkpoints are written).

``plex_from_arrays`` takes one index's key array, spline, radix layer and
tuning; ``snapshot_from_arrays`` takes, as numpy arrays, what a sharded PLEX
snapshot holds — the key array, the shard offsets, and per shard the spline,
the radix layer and the tuning — and assembles the port's ``Snapshot``.
Neither rebuilds anything.
So an index built elsewhere (the reference package, or a persisted
generation once the port reads them) is served by the port as it is.

Per shard, ``shards[s]`` is a mapping with

* ``spline_keys`` (uint64) and ``spline_positions`` (int64);
* ``layer``: ``{"kind": "radix", "table", "shift", "r", "min_key"}`` or
  ``{"kind": "cht", "cells", "r", "delta", "max_depth"}``;
* ``tuning``: the keyword fields of ``core.autotune.TuneResult``.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .checkpoint.store import to_host
from .configs.base import ArchConfig
from .core.autotune import TuneResult
from .core.cht import CHT
from .core.index import Snapshot
from .core.plex import PLEX, BuildStats
from .core.radix_table import RadixTable
from .core.spline import Spline
from .device import resolve_device
from .models.lm import build_segments, check_ported
from .optim import AdamWState


def _layer(spec: Mapping[str, Any], n_spline: int):
    kind = spec["kind"]
    if kind == "radix":
        table = np.ascontiguousarray(spec["table"], dtype=np.uint32)
        return RadixTable(r=int(spec["r"]), min_key=np.uint64(spec["min_key"]),
                          shift=int(spec["shift"]), table=table,
                          n_keys=n_spline)
    if kind == "cht":
        r = int(spec["r"])
        cells = np.ascontiguousarray(spec["cells"], dtype=np.uint32)
        if cells.size % (1 << r):
            raise ValueError("CHT cells are not a whole number of nodes")
        return CHT(r=r, delta=int(spec["delta"]), cells=cells,
                   n_nodes=cells.size >> r, max_depth=int(spec["max_depth"]),
                   n_keys=n_spline)
    raise ValueError(f"unknown layer kind {kind!r}")


def plex_from_arrays(keys: np.ndarray, spline_keys: np.ndarray,
                     spline_positions: np.ndarray, layer: Mapping[str, Any],
                     tuning: Mapping[str, Any], eps: int) -> PLEX:
    """One port ``PLEX`` over these arrays (``layer`` and ``tuning`` as in
    the module docstring), with no rebuild: a ``LearnedIndex(plex=...)``
    over it gives the same window bases and ranks as the index the arrays
    came from."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    sk = np.ascontiguousarray(spline_keys, dtype=np.uint64)
    sp = np.ascontiguousarray(spline_positions, dtype=np.int64)
    if sk.size != sp.size or sk.size == 0:
        raise ValueError("spline keys and positions must be non-empty and "
                         "of one length")
    spline = Spline(keys=sk, positions=sp, eps=int(eps), n_keys=keys.size)
    return PLEX(spline=spline, layer=_layer(layer, sk.size),
                tuning=TuneResult(**tuning), keys=keys, eps=int(eps),
                stats=BuildStats(0.0, 0.0, 0.0, 0.0))


def snapshot_from_arrays(keys: np.ndarray, offsets: np.ndarray,
                         shards: Sequence[Mapping[str, Any]], eps: int,
                         device=None) -> Snapshot:
    """The port's ``Snapshot`` over these arrays (see the module docstring);
    its stacked planes go to ``device`` (default: the CUDA card)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if len(shards) != offsets.size or offsets[0] != 0:
        raise ValueError("one shard per offset, starting at 0")
    ends = np.append(offsets[1:], keys.size)
    plexes = [plex_from_arrays(keys[lo:hi], sh["spline_keys"],
                               sh["spline_positions"], sh["layer"],
                               sh["tuning"], eps)
              for lo, hi, sh in zip(offsets, ends, shards)]
    return Snapshot(keys, eps, offsets, plexes, device=device)


def _unstack(tree, r: int):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return tree[r]


def _to_tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def lm_params_from_arrays(cfg: ArchConfig, tree: Mapping[str, Any],
                          device=None) -> dict:
    """The port ``Model``'s parameters from the reference's params pytree
    as numpy arrays (``jax.tree.map(np.asarray, params)``): every leaf of a
    segment loses its stacked leading ``[n]`` into one dict per layer, the
    rest is carried as it is, nested leaves too (MLA's and the MoE's,
    RWKV's ``mixer``/``mlp`` with ``mu`` ``[n, 5, d]`` -> ``[5, d]``, the
    RG-LRU's), all on ``device`` (default: the CUDA card). The port then
    computes the reference model's function."""
    check_ported(cfg)
    out = dict(tree)            # embed, in_proj, final_norm, lm_head
    for si, seg in enumerate(build_segments(cfg)):
        out[f"seg{si}"] = {
            blk: [_unstack(leaves, r) for r in range(seg.repeats)]
            for blk, leaves in tree[f"seg{si}"].items()}
    return _to_tensors(out, resolve_device(device))


def _stack(layers: list):
    """One tree from a layer's trees: each leaf stacked on a new leading
    dim, as numpy (tensors copied to the host)."""
    if isinstance(layers[0], Mapping):
        return {k: _stack([t[k] for t in layers]) for k in layers[0]}
    return np.stack([to_host(t) for t in layers])


def lm_arrays_from_params(cfg: ArchConfig, params: Mapping[str, Any]
                          ) -> dict:
    """The reference's params pytree, as numpy, from the port ``Model``'s
    parameters (or any tree shaped like them, AdamW's moments too): each
    segment's layers stacked into ``[n, ...]`` leaves, the rest copied to
    the host as it is; the inverse of ``lm_params_from_arrays``."""
    check_ported(cfg)
    out = {k: to_host(v) for k, v in params.items()
           if not k.startswith("seg")}
    for si, _ in enumerate(build_segments(cfg)):
        out[f"seg{si}"] = {blk: _stack(layers)
                           for blk, layers in params[f"seg{si}"].items()}
    return out


def stacked_axes(axes: Mapping[str, tuple]) -> dict[str, tuple]:
    """The logical axes by path (``Model.init_with_axes``) of the
    reference's layout, whose segment leaves carry the stacked layer dim
    first (``None``): the reference's ``ParamCollector.axes``, for
    ``parallel.tree_shardings`` over ``lm_arrays_from_params``' trees."""
    return {k: ((None,) + tuple(v) if k.startswith("seg") else tuple(v))
            for k, v in axes.items()}


def train_state_to_arrays(cfg: ArchConfig, params, opt: AdamWState) -> dict:
    """``{"params": ..., "opt": AdamWState(step, m, v)}`` as numpy in the
    reference's layout: what its training launcher checkpoints, so the
    files the port writes are the reference's for the same state."""
    return {"params": lm_arrays_from_params(cfg, params),
            "opt": AdamWState(step=to_host(opt.step),
                              m=lm_arrays_from_params(cfg, opt.m),
                              v=lm_arrays_from_params(cfg, opt.v))}


def train_state_from_arrays(cfg: ArchConfig, tree: Mapping[str, Any],
                            device=None) -> tuple[dict, AdamWState]:
    """(params, AdamW state) of the port on ``device`` (default: the card)
    from ``{"params", "opt"}`` in the reference's layout (a restored
    checkpoint of either package)."""
    device = resolve_device(device)
    opt = tree["opt"]
    return (lm_params_from_arrays(cfg, tree["params"], device),
            AdamWState(step=torch.from_numpy(
                           np.array(opt[0], dtype=np.int32)).to(device),
                       m=lm_params_from_arrays(cfg, opt[1], device),
                       v=lm_params_from_arrays(cfg, opt[2], device)))
