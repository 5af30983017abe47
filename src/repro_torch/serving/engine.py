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

Recurrent caches (RWKV's time and channel state, RG-LRU's conv tail and
``h``) and the ``wattn`` ring buffer take two more repairs:

* The reference never resets a slot's state when it admits a request
  (``src/repro/serving/engine.py:64-69``), so a request in a used slot
  starts from its predecessor's recurrent state (ROADMAP queue 3, R12).
  ``_admit`` zeroes the admitted slot's recurrent rows. K/V rows need no
  reset: positions not yet written are masked.
* The ring's key positions ``kpos`` are one ``[n, window]`` plane that
  every batch row shares (``src/repro/models/lm.py:343-345``); once a slot
  has wrapped the ring, slots at other positions relabel its keys (R13).
  The engine keeps one ring-position row per slot, ``ring[path]`` of
  ``[n, B, window]``, beside the model's cache, whose layout stays the
  reference's. Slots of one position group share ``pos`` and, since each
  was reset on admission, the same ring history: the group passes one row
  to ``serve_step`` and the stepped row is copied back to each of its
  slots. Admission resets a slot's row to ``EMPTY_POS``.

A first block with neither K/V nor latents (a recurrent one) swaps nothing
out: ``_slot_kv`` returns ``None`` and the request reports 0 pages, as in
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import EMPTY_POS, Model, init_cache
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


# cache leaves indexed by position, whose stale rows masking hides; every
# other leaf with a batch dim is recurrent state
POSITIONAL = ("k", "v", "c", "k_rope")
RING = "kpos"


def cache_leaves(tree: dict, path: tuple = ()):
    """(path, tensor) of every leaf of a nested cache, in order."""
    for name, t in tree.items():
        if isinstance(t, dict):
            yield from cache_leaves(t, path + (name,))
        else:
            yield path + (name,), t


def _map_cache(tree: dict, fn, path: tuple = ()) -> dict:
    """The cache's nesting with ``fn(path, tensor)`` at every leaf."""
    return {name: (_map_cache(t, fn, path + (name,)) if isinstance(t, dict)
                   else fn(path + (name,), t))
            for name, t in tree.items()}


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    for name in path:
        tree = tree[name]
    return tree


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
        # one ring-position row a slot for every wattn entry, [n, B, window]
        self.ring = {path: t[:, None].repeat(1, batch_size, 1)
                     for path, t in cache_leaves(self.cache)
                     if path[-1] == RING}
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
                self._reset_slot(i)
                self.slots[i] = {"req": req, "pos": 0, "out": []}

    def _reset_slot(self, slot: int) -> None:
        """A fresh sequence's state in ``slot``: its recurrent rows zero, its
        ring row ``EMPTY_POS`` (R12, R13)."""
        for path, t in cache_leaves(self.cache):
            if path[-1] not in POSITIONAL + (RING,):
                t[:, slot].zero_()
        for ring in self.ring.values():
            ring[:, slot] = EMPTY_POS

    def _step_group(self, toks: np.ndarray, idxs: list[int], pos: int
                    ) -> np.ndarray:
        """``serve_step`` at ``pos`` on the cache rows of the slots ``idxs``
        only, gathered and scattered back; float32 logits [len(idxs), V] on
        the host."""
        rows = torch.as_tensor(idxs, dtype=torch.long, device=self.device)

        def gather(path, t):
            if path[-1] == RING:        # the group's shared ring row
                return self.ring[path][:, idxs[0]].clone()
            return t.index_select(1, rows)
        sub = _map_cache(self.cache, gather)
        logits, sub = self.model.serve_step(
            self.params, sub, torch.from_numpy(toks[idxs]).to(self.device),
            pos)
        for path, t in cache_leaves(sub):
            if path[-1] == RING:
                self.ring[path][:, rows] = t[:, None]
            else:
                _leaf(self.cache, path).index_copy_(1, rows, t)
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
        kv = self._slot_kv(slot, s["pos"])
        pages = 0 if kv is None else self.kv_store.store(req.seq_id, kv)
        self.finished.append(Finished(seq_id=req.seq_id,
                                      tokens=np.asarray(s["out"], np.int32),
                                      swapped_pages=pages))
        self.slots[slot] = None

    def _slot_kv(self, slot: int, n_tokens: int) -> np.ndarray | None:
        """This slot's per-layer cache of the first segment, [T, ...]
        float32, for swap-out (the reference's layout): K and V side by
        side, MLA's latent ``c`` alone, or ``None`` for a recurrent first
        block."""
        blk = self.cache["seg0"]["blk0"]
        if "k" not in blk and "c" not in blk:
            return None
        if "c" in blk:
            c = blk["c"][:, slot, :n_tokens].float().cpu().numpy()
            return c.transpose(1, 0, 2).reshape(n_tokens, -1)
        k = blk["k"][:, slot, :n_tokens].float().cpu().numpy()
        v = blk["v"][:, slot, :n_tokens].float().cpu().numpy()
        return np.concatenate([k, v], axis=-1).transpose(1, 0, 2, 3).reshape(
            n_tokens, -1)
