"""Train and serve step functions (the port of ``repro.models.steps``).

The LM loss streams the vocab projection in ``cfg.logits_chunk`` sequence
chunks, each recomputed in the backward pass (``torch.utils.checkpoint``),
so the ``[B, S, V]`` float32 logits never exist at once: at qwen2-vl's
vocab of 151,936 they would be 2.5 GB a sequence of 4,096 tokens.

Training takes gradients with ``torch.autograd`` through ``Model.forward``
(each layer recomputed under ``cfg.remat``; a GQA layer's attention is K5
forward with the plain function's gradient, ``layers.attention.
K5Attention``), accumulates ``cfg.grad_accum`` micro-batches' float32
gradients and applies AdamW in place (``optim.adamw``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..layers.grad import taking_grad
from ..optim import AdamWState, adamw_init, adamw_update
from ..optim.adamw import leaves
from .lm import Model

AUX_COEF = 0.001


def _chunk_ce(xx: torch.Tensor, yy: torch.Tensor, head: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed CE over labels >= 0, their count) of one chunk; the logits
    are the products of ``cfg.dtype`` values summed in float32 (the
    reference's ``preferred_element_type``: both sides widened exactly)."""
    logits = torch.matmul(xx.float(), head.float())
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yy.clamp_min(0).long()[..., None])[..., 0]
    mask = (yy >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_ce_loss(model: Model, params, x: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labels >= 0; x [B,S,d] final hidden, labels [B,S]
    (``src/repro/models/steps.py:23-54``)."""
    cfg = model.cfg
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    head = head.to(x.dtype)
    s = x.shape[1]
    c = min(cfg.logits_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the logits "
                         f"chunk {c}")
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        xx, yy = x[:, c0:c0 + c], labels[:, c0:c0 + c]
        if taking_grad(xx, head):
            part, n = checkpoint(_chunk_ce, xx, yy, head, use_reentrant=False)
        else:
            part, n = _chunk_ce(xx, yy, head)
        loss_sum = loss_sum + part
        cnt = cnt + n
    return loss_sum / torch.clamp_min(cnt, 1.0)


def loss_fn(model: Model, params, batch: dict) -> torch.Tensor:
    """CE plus ``AUX_COEF`` times the MoE's summed aux loss."""
    x, aux = model.forward(params, batch)
    ce = chunked_ce_loss(model, params, x, batch["labels"])
    return ce + AUX_COEF * aux


def loss_and_grad(model: Model, params, batch: dict
                  ) -> tuple[torch.Tensor, list]:
    """(loss, the gradient of every leaf of ``params`` in the order of
    ``optim.adamw.leaves``). The leaves are used as they are; ``requires_grad`` is set on
    them for the call and cleared after."""
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
    try:
        loss = loss_fn(model, params, batch)
        grads = torch.autograd.grad(loss, ts, allow_unused=True)
    finally:
        for t in ts:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(ts, grads)]
    return loss.detach(), grads


def make_train_step(model: Model, lr=3e-4):
    """(params, opt_state, batch) -> (loss, params, opt_state), params and
    state updated in place (``src/repro/models/steps.py:62-100``).

    ``cfg.grad_accum`` > 1 splits the batch into that many micro-batches
    along the batch dim (rows ``[i*B/n, (i+1)*B/n)``), sums their float32
    gradients and divides by n, as the reference's scan does."""
    accum = model.cfg.grad_accum

    def train_step(params, opt_state: AdamWState, batch: dict):
        if accum <= 1:
            loss, grads = loss_and_grad(model, params, batch)
        else:
            loss = None
            grads = None
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                l_i, g_i = loss_and_grad(model, params, mb)
                if grads is None:
                    loss, grads = l_i, [g.float() for g in g_i]
                else:
                    loss = loss + l_i
                    for acc, g in zip(grads, g_i):
                        acc.add_(g.float())
            loss = loss / accum
            grads = [g / accum for g in grads]
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return loss, params, opt_state

    return train_step


def make_eval_step(model: Model):
    """(params, batch) -> the loss, no gradient."""

    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(model, params, batch)
    return eval_step


def make_prefill_step(model: Model):
    """Forward returning last-position logits (the prefill_32k unit): each
    GQA layer's attention is one K5 launch; an MLA layer's attention, and a
    ``wattn`` layer's windowed one, is the plain ``flash_attention``
    (``layers/mla.py``, ``layers/attention.py``); RWKV and RG-LRU layers
    run their chunked and scanned recurrences."""

    def prefill_step(params, batch):
        x, _ = model.forward(params, batch)
        return model.logits(params, x[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(model: Model):
    """(params, cache, tokens [B,1], pos) -> (next token logits, cache)."""

    def serve_step(params, cache, tokens, pos):
        return model.serve_step(params, cache, tokens, pos)

    return serve_step


def init_train_state(model: Model, seed: int = 0, device=None
                     ) -> tuple[Any, AdamWState]:
    """(params, AdamW state) drawn on ``device`` (default: the card)."""
    params = model.init(seed, device=resolve_device(device))
    return params, adamw_init(params)
