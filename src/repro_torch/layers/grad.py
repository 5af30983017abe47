"""Whether a call is taking a gradient: the one test by which the port's
layers choose their training form (``models.lm``'s remat, the chunked LM
loss's recomputed chunks, ``layers.scan``'s out-of-place steps)."""
from __future__ import annotations

import torch


def taking_grad(*trees) -> bool:
    """True when autograd records a graph through ``trees``: grad mode is
    on and a tensor among them (nested in dicts, lists and tuples) requires
    a gradient. A forward that is not differentiated (prefill, decode,
    evaluation) gets False, whether or not it runs under ``no_grad``."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.requires_grad:
                return True
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
    return False
