"""Serving step functions (the port of ``repro.models.steps``'
``make_prefill_step`` and ``make_serve_step``; training waits for the
optimizer's port)."""
from __future__ import annotations

from .lm import Model


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
