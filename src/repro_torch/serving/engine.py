"""Batched serving engine: continuous batching over ``Model.serve_step``
(the port of ``repro.serving.engine``).

Fixed decode slots, per-slot sequence state, greedy sampling, EOS/max-len
retirement, and PLEX-paged swap-out of finished sequences' KV, or MLA's
latents (``kv_cache.PagedKVStore``). Prompts go through the decode step
token by token, as in the reference; batched prefill is ``models.steps.
make_prefill_step``.

Slots at different positions step in groups, one ``serve_step`` per
distinct position. The reference passes the whole batch to every group's
step, so each step writes every slot's K/V at that group's position and
overwrites the history of slots in other groups (ROADMAP queue 3, R6). Here
a group steps on the sub-batch of its own slots: their cache rows are
gathered, stepped and scattered back, and a slot outside the group is never
written. On aligned traffic this gives the reference's tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import Model, init_cache
from .kv_cache import PagedKVStore


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray
    max_new: int = 32
    eos: int = -1


@dataclasses.dataclass
class Finished:
    seq_id: int
    tokens: np.ndarray
    swapped_pages: int


def _map_cache(cache: dict, fn) -> dict:
    return {seg: {blk: {name: fn(t) for name, t in entry.items()}
                  for blk, entry in blks.items()}
            for seg, blks in cache.items()}


class ServeEngine:
    def __init__(self, model: Model, params, *, batch_size: int = 4,
                 max_seq: int = 256, page_tokens: int = 16,
                 pool_pages: int = 4096, device=None):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.b = batch_size
        self.max_seq = max_seq
        self.cache = init_cache(model.cfg, batch_size, max_seq,
                                device=self.device)
        self.kv_store = PagedKVStore(page_tokens=page_tokens,
                                     n_pages=pool_pages)
        self.slots: list[dict | None] = [None] * batch_size
        self.queue: list[Request] = []
        self.finished: list[Finished] = []
        self.steps = 0

    # -- public -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> list[Finished]:
        while (any(self.slots) or self.queue) and max_steps:
            self.step()
            max_steps -= 1
        return self.finished

    # -- internals ----------------------------------------------------------
    def _admit(self) -> None:
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = {"req": req, "pos": 0, "out": []}

    def _step_group(self, toks: np.ndarray, idxs: list[int], pos: int
                    ) -> np.ndarray:
        """``serve_step`` at ``pos`` on the cache rows of the slots ``idxs``
        only, gathered and scattered back; float32 logits [len(idxs), V] on
        the host."""
        rows = torch.as_tensor(idxs, dtype=torch.long, device=self.device)
        sub = _map_cache(self.cache, lambda t: t.index_select(1, rows))
        logits, sub = self.model.serve_step(
            self.params, sub, torch.from_numpy(toks[idxs]).to(self.device),
            pos)
        for seg, blks in sub.items():
            for blk, entry in blks.items():
                for name, t in entry.items():
                    self.cache[seg][blk][name].index_copy_(1, rows, t)
        return logits.float().cpu().numpy()

    def step(self) -> None:
        self._admit()
        if not any(self.slots):
            return
        # one token per active slot: either next prompt token (prefill) or
        # the previously sampled token (decode)
        toks = np.zeros((self.b, 1), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req = s["req"]
            if s["pos"] < len(req.prompt):
                toks[i, 0] = req.prompt[s["pos"]]
            else:
                toks[i, 0] = s["out"][-1] if s["out"] else 0
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(self.slots):
            if s is not None:
                groups.setdefault(s["pos"], []).append(i)
        for pos, idxs in sorted(groups.items()):
            lg = self._step_group(toks, idxs, pos)
            for row, i in enumerate(idxs):
                s = self.slots[i]
                req = s["req"]
                s["pos"] += 1
                if s["pos"] >= len(req.prompt):      # decoding region
                    nxt = int(np.argmax(lg[row]))
                    s["out"].append(nxt)
                    if (len(s["out"]) >= req.max_new
                            or nxt == req.eos
                            or s["pos"] >= self.max_seq - 1):
                        self._retire(i)
        self.steps += 1

    def _retire(self, slot: int) -> None:
        s = self.slots[slot]
        req = s["req"]
        # swap this sequence's KV out through the PLEX-paged store
        pages = self.kv_store.store(req.seq_id, self._slot_kv(slot, s["pos"]))
        self.finished.append(Finished(seq_id=req.seq_id,
                                      tokens=np.asarray(s["out"], np.int32),
                                      swapped_pages=pages))
        self.slots[slot] = None

    def _slot_kv(self, slot: int, n_tokens: int) -> np.ndarray:
        """This slot's per-layer cache of the first segment, [T, ...]
        float32, for swap-out (the reference's layout): K and V side by
        side, or MLA's latent ``c`` alone."""
        blk = self.cache["seg0"]["blk0"]
        if "c" in blk:
            c = blk["c"][:, slot, :n_tokens].float().cpu().numpy()
            return c.transpose(1, 0, 2).reshape(n_tokens, -1)
        k = blk["k"][:, slot, :n_tokens].float().cpu().numpy()
        v = blk["v"][:, slot, :n_tokens].float().cpu().numpy()
        return np.concatenate([k, v], axis=-1).transpose(1, 0, 2, 3).reshape(
            n_tokens, -1)
