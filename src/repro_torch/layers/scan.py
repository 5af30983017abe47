"""The first-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over
one dimension, in log depth.

The reference computes RG-LRU's recurrence with ``jax.lax.associative_scan``
(``src/repro/layers/rglru.py:55-69``) and RWKV6's chunk-to-chunk WKV state
with ``jax.lax.scan`` (``src/repro/layers/rwkv.py:82-107``); torch has
neither. ``linear_scan`` is a doubling (Hillis-Steele) scan: ceil(log2 n)
steps of whole-tensor products, 15 at 32,768 positions, where a Python loop
over positions would launch a few kernels a position. It computes the same
function; only the float32 summation order differs. Prefill and decode
update two scratch copies in place; when a gradient is taken
(``layers.grad.taking_grad``), each step builds new tensors from the same
products instead (autograd refuses a tensor overwritten after a product
saved it), so the numbers are the prefill's. The two forms are kept for
speed: the out-of-place one copies the whole state once more a step, and
made rwkv6's 32,768-token prefill 16% slower (1.05 s to 1.22 s on an H100,
``tools/train_paths_ab.py``).
"""
from __future__ import annotations

import torch

from .grad import taking_grad


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``h_t`` of ``h_t = a_t * h_{t-1} + b_t`` along ``dim``, from
    ``h_{-1} = 0``. ``a`` broadcasts against ``b`` (a per-row decay of a
    matrix state is ``[..., D, 1]`` against ``[..., D, D]``)."""
    n = b.shape[dim]
    if taking_grad(a, b):
        return _linear_scan_out_of_place(a, b, dim)
    a, b = a.clone(), b.clone()
    step = 1
    while step < n:
        hi = n - step
        # each right-hand side is a fresh tensor, so every step reads the
        # values of the step before
        b.narrow(dim, step, hi).add_(a.narrow(dim, step, hi)
                                     * b.narrow(dim, 0, hi))
        if 2 * step < n:
            a.narrow(dim, step, hi).copy_(a.narrow(dim, step, hi)
                                          * a.narrow(dim, 0, hi))
        step *= 2
    return b


def _linear_scan_out_of_place(a: torch.Tensor, b: torch.Tensor,
                              dim: int) -> torch.Tensor:
    """``linear_scan``'s steps, each as new tensors (for autograd)."""
    n = b.shape[dim]
    step = 1
    while step < n:
        hi = n - step
        b = torch.cat([b.narrow(dim, 0, step),
                       b.narrow(dim, step, hi)
                       + a.narrow(dim, step, hi) * b.narrow(dim, 0, hi)],
                      dim=dim)
        if 2 * step < n:
            a = torch.cat([a.narrow(dim, 0, step),
                           a.narrow(dim, step, hi) * a.narrow(dim, 0, hi)],
                          dim=dim)
        step *= 2
    return b
