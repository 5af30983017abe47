"""Error-feedback top-k gradient compression (the port of
``repro.optim.compress``).

``compress(g + e)`` is sent and the residual ``e`` keeps what was dropped.
A leaf keeps every element whose magnitude is at least the k-th largest
(k = max(int(size * density), 1)), so ties at the threshold keep more than
k, as the reference's ``_topk_mask`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .adamw import _map, leaves


class CompressState(NamedTuple):
    residual: Any


def compress_init(params: Any) -> CompressState:
    """Zero float32 residuals shaped like ``params``."""
    return CompressState(residual=_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _topk_mask(x: torch.Tensor, density: float) -> torch.Tensor:
    k = max(int(x.numel() * density), 1)
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def _unflatten(flat: list, like):
    it = iter(flat)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        return next(it)
    return fill(like)


@torch.no_grad()
def compress_grads(grads: Any, state: CompressState, *,
                   density: float = 0.05) -> tuple[Any, CompressState, dict]:
    """-> (sparse grads to all-reduce, new residual state, stats). ``grads``
    is a tree shaped like the residual or the list of its leaves in
    ``adamw.leaves`` order (then the sent gradients are a list too)."""
    as_list = isinstance(grads, list)
    g_leaves = grads if as_list else leaves(grads)
    sent, resid = [], []
    for g, e in zip(g_leaves, leaves(state.residual)):
        acc = g.float() + e
        s = acc * _topk_mask(acc, density)
        sent.append(s)
        resid.append(acc - s)
    total = sum(g.numel() for g in g_leaves)
    stats = {"density": density, "sent_elems": int(total * density),
             "total_elems": int(total)}
    return ((sent if as_list else _unflatten(sent, grads)),
            CompressState(residual=_unflatten(resid, state.residual)), stats)
