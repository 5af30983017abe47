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

Under a ``DeviceMesh`` (``parallel.set_mesh_rules``) the parameters and the
batch are this rank's blocks (the production layout): the CE runs over the
rank's vocab block where the rules split the vocab, each rank's loss is its
rows' share of the whole batch's mean, the gradients are reduced over the
batch ranks that do not split a leaf (FSDP's leaves were reduce-scattered
in the backward), and AdamW clips by the norm over every rank's blocks.
With ``grad_accum`` > 1, a rank's micro-batch i is its own rows' i-th
slice, so the MoE's aux loss (a product of batch means) is taken over
other rows than the reference's global micro-batch.
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


def _chunk_ce_vocab(xx: torch.Tensor, yy: torch.Tensor, head: torch.Tensor,
                    v0: int, group) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunk_ce`` over this rank's vocab block ``[v0, v0 + V/n)`` of the
    head: the max, the sum of exponentials and the target logit are
    reduced over ``model`` (``group``), so every rank gets the whole
    chunk's CE."""
    from ..parallel.collectives import ReduceFromModel, all_reduce_
    logits = torch.matmul(xx.float(), head.float())
    vl = logits.shape[-1]
    top = all_reduce_(logits.detach().amax(dim=-1), group, "max")
    se = ReduceFromModel.apply(torch.exp(logits - top[..., None]).sum(-1),
                               group)
    lse = torch.log(se) + top
    local = yy.long() - v0
    inside = ((local >= 0) & (local < vl)).float()
    ll = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    ll = ReduceFromModel.apply(ll * inside, group)
    mask = (yy >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_ce_sum(model: Model, params, x: torch.Tensor,
                   labels: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the summed CE over labels >= 0, their count); x [B,S,d] final
    hidden, labels [B,S]. Under a mesh whose rules split the vocab over
    ``model`` each rank projects its vocab block (``_chunk_ce_vocab``), ``x``
    entering through ``copy_to_model``."""
    from ..parallel.collectives import layout
    cfg = model.cfg
    lay = layout()
    head, split = model.head(lay, params, x.dtype)
    chunk_fn, extra = _chunk_ce, ()
    if split:
        x = lay.copy_to_model(x)
        chunk_fn = _chunk_ce_vocab
        extra = (lay.model_block(cfg.vocab)[0], lay.group("model"))
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
            part, n = checkpoint(chunk_fn, xx, yy, head, *extra,
                                 use_reentrant=False)
        else:
            part, n = chunk_fn(xx, yy, head, *extra)
        loss_sum = loss_sum + part
        cnt = cnt + n
    return loss_sum, cnt


def chunked_ce_loss(model: Model, params, x: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labels >= 0 (of this rank's rows, under a mesh); x
    [B,S,d] final hidden, labels [B,S]
    (``src/repro/models/steps.py:23-54``)."""
    loss_sum, cnt = chunked_ce_sum(model, params, x, labels)
    return loss_sum / torch.clamp_min(cnt, 1.0)


def _losses(model: Model, params, batch: dict, lay
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the loss this rank differentiates, the whole batch's loss
    detached). Under a mesh (``lay``) a rank's loss is its rows' CE over
    the count of every batch rank's labels, plus the replicated aux once,
    so the gradients summed over the batch ranks are the whole batch's;
    with ``WHOLE`` both are ``loss_fn``."""
    x, aux = model.forward(params, batch)
    part, cnt = chunked_ce_sum(model, params, x, batch["labels"])
    ce = part / torch.clamp_min(lay.batch_sum_(cnt.detach().clone()), 1.0)
    whole = lay.batch_sum_(ce.detach().clone()) + AUX_COEF * aux
    return ce + AUX_COEF * aux, whole.detach()


def loss_fn(model: Model, params, batch: dict) -> torch.Tensor:
    """CE plus ``AUX_COEF`` times the MoE's summed aux loss (under a mesh,
    this rank's share of it: ``_losses``)."""
    return _losses(model, params, batch, model.active_layout())[0]


def _local_loss_and_grad(model: Model, params, batch: dict, lay
                         ) -> tuple[torch.Tensor, list]:
    """(the whole batch's loss, every leaf's gradient in ``leaves`` order)
    before any reduction over the batch ranks (``_losses``)."""
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
    try:
        loss, shown = _losses(model, params, batch, lay)
        grads = torch.autograd.grad(loss, ts, allow_unused=True)
    finally:
        for t in ts:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(ts, grads)]
    return shown, grads


def _reduce_grads(model: Model, lay, grads: list) -> list:
    """Each leaf's gradient summed over the batch ranks that do not split
    it (``Layout.reduce_grad_``); with ``WHOLE``, as they are."""
    specs = model.leaf_specs(lay)
    if specs is None:
        return grads
    return [lay.reduce_grad_(g.contiguous(), spec)
            for g, spec in zip(grads, specs)]


def loss_and_grad(model: Model, params, batch: dict
                  ) -> tuple[torch.Tensor, list]:
    """(loss, the gradient of every leaf of ``params`` in the order of
    ``optim.adamw.leaves``). The leaves are used as they are;
    ``requires_grad`` is set on them for the call and cleared after. Under
    a mesh the params and batch are this rank's blocks; the loss is the
    whole batch's and each gradient is this rank's block of the whole
    gradient."""
    lay = model.active_layout()
    loss, grads = _local_loss_and_grad(model, params, batch, lay)
    return loss, _reduce_grads(model, lay, grads)


def make_train_step(model: Model, lr=3e-4):
    """(params, opt_state, batch) -> (loss, params, opt_state), params and
    state updated in place (``src/repro/models/steps.py:62-100``).

    ``cfg.grad_accum`` > 1 splits the batch into that many micro-batches
    along the batch dim (rows ``[i*B/n, (i+1)*B/n)``), sums their float32
    gradients and divides by n, as the reference's scan does. Under a mesh
    the summed gradients are reduced over the batch ranks once, and AdamW
    clips by the norm over every rank's blocks."""
    accum = model.cfg.grad_accum

    def train_step(params, opt_state: AdamWState, batch: dict):
        lay = model.active_layout()
        if accum <= 1:
            loss, grads = _local_loss_and_grad(model, params, batch, lay)
        else:
            loss = None
            grads = None
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                l_i, g_i = _local_loss_and_grad(model, params, mb, lay)
                if grads is None:
                    loss, grads = l_i, [g.float() for g in g_i]
                else:
                    loss = loss + l_i
                    for acc, g in zip(grads, g_i):
                        acc.add_(g.float())
            loss = loss / accum
            grads = [g / accum for g in grads]
        grads = _reduce_grads(model, lay, grads)
        specs = model.leaf_specs(lay)
        mesh_kw = {} if specs is None else {"specs": specs}
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         **mesh_kw)
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
