"""AdamW with global-norm clipping (the port of ``repro.optim.adamw``).

The state is ``AdamWState(step, m, v)``: ``step`` an int32 scalar tensor,
``m`` and ``v`` trees shaped like the parameters (zeros of the parameters'
dtype, as the reference's ``zeros_like``). ``adamw_update`` computes the
reference's update, the gradients widened to float32 and scaled by
``min(1, clip_norm / max(||g||, 1e-9))`` over every leaf, the bias
corrections ``1 - b ** step`` in float32, and writes the new parameters,
``m`` and ``v`` in place, one leaf at a time (a full-width model's state
is 16 bytes a parameter, so nothing is copied whole); it returns the same
objects.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree) -> list:
    """A tree's tensors in a fixed order (dict keys sorted, lists in
    order): the order ``models.steps.loss_and_grad`` gives gradients in."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def adamw_init(params: Any) -> AdamWState:
    """Zero moments shaped like ``params``, step 0."""
    leaf = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      m=_map(torch.zeros_like, params),
                      v=_map(torch.zeros_like, params))


def global_norm(grads: list, specs: list | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.

    ``specs`` (each leaf's spec, under an active ``DeviceMesh``): the leaves
    are this rank's blocks, and each leaf's sum of squares is summed over
    the mesh dims that split it and counted once over those that replicate
    it, so every rank gets the reference's norm of the whole gradient."""
    from ..parallel.collectives import all_reduce_, layout
    lay = layout()
    by_dims: dict = {}
    for i, g in enumerate(grads):
        dims = () if specs is None else tuple(sorted(lay.split_dims(
            specs[i])))
        part = torch.sum(torch.square(g.float()))
        by_dims[dims] = by_dims[dims] + part if dims in by_dims else part
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for dims in sorted(by_dims):
        part = by_dims[dims].reshape(1).contiguous()
        for m in dims:
            all_reduce_(part, lay.group(m))
        total = total + part[0]
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params: Any, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 specs: list | None = None) -> tuple[Any, AdamWState]:
    """One AdamW step (``src/repro/optim/adamw.py:31-56``). ``grads`` is a
    tree shaped like ``params`` or the list of its leaves in ``leaves``
    order; ``lr`` a float or a function of the new step (an int32 scalar
    tensor). Under a mesh, ``specs`` are the leaves' specs (``global_norm``)
    and the update runs on this rank's blocks."""
    p_leaves = leaves(params)
    g_leaves = grads if isinstance(grads, list) else leaves(grads)
    m_leaves, v_leaves = leaves(state.m), leaves(state.v)
    gnorm = global_norm(g_leaves, specs)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                           device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                           device=stepf.device) ** stepf
    lr_t = lr(step) if callable(lr) else lr
    for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.copy_(p - lr_t * upd)
    return params, AdamWState(step=step, m=state.m, v=state.v)
