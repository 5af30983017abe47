"""Paged KV storage with a PLEX page table (the port of
``repro.serving.kv_cache``: host numpy on the port's ``build_plex`` and the
host ``PLEX.lookup``).

The page table maps logical page keys ``(seq_id << 24) | page_no`` (sorted
u64) to physical page slots. At serving scale the table holds millions of
entries and every decode step issues thousands of translations — the exact
batched sorted-key lookup PLEX accelerates with an eps-bounded probe.

The index is rebuilt lazily: allocations/frees accumulate in a small sorted
delta overlay and are merged into the PLEX-indexed main array when the
overlay exceeds ``rebuild_threshold`` (PLEX builds are single-pass O(N), the
paper's headline property, so rebuilds are cheap — this is the update
strategy the paper's future-work section sketches via Fenwick trees,
simplified to overlay+rebuild)."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import build_plex

SEQ_SHIFT = np.uint64(24)


def page_key(seq_id: int | np.ndarray, page_no: int | np.ndarray
             ) -> np.ndarray:
    return ((np.asarray(seq_id, np.uint64) << SEQ_SHIFT)
            | np.asarray(page_no, np.uint64))


class PageTable:
    """Sorted (key -> physical page) map: PLEX main + small sorted overlay."""

    def __init__(self, rebuild_threshold: int = 1024, eps: int = 16):
        self.eps = eps
        self.rebuild_threshold = rebuild_threshold
        self.keys = np.zeros(0, np.uint64)
        self.vals = np.zeros(0, np.int64)
        self.overlay: dict[int, int] = {}
        self.plex = None
        self.rebuilds = 0
        self.lookups = 0

    def __len__(self) -> int:
        return self.keys.size + len(self.overlay)

    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        for k, v in zip(np.asarray(keys, np.uint64),
                        np.asarray(vals, np.int64)):
            self.overlay[int(k)] = int(v)
        if len(self.overlay) >= self.rebuild_threshold:
            self._rebuild()

    def remove(self, keys: np.ndarray) -> None:
        for k in np.asarray(keys, np.uint64):
            self.overlay[int(k)] = -1          # tombstone
        if len(self.overlay) >= self.rebuild_threshold:
            self._rebuild()

    def _rebuild(self) -> None:
        if self.overlay:
            ok = np.fromiter(self.overlay.keys(), np.uint64,
                             len(self.overlay))
            ov = np.fromiter(self.overlay.values(), np.int64,
                             len(self.overlay))
            keep = ~np.isin(self.keys, ok)
            keys = np.concatenate([self.keys[keep], ok[ov >= 0]])
            vals = np.concatenate([self.vals[keep], ov[ov >= 0]])
            order = np.argsort(keys, kind="stable")
            self.keys, self.vals = keys[order], vals[order]
            self.overlay.clear()
        if self.keys.size:
            self.plex = build_plex(self.keys, eps=self.eps)
            self.rebuilds += 1

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Physical pages (-1 = unmapped). Batched; overlay checked first."""
        keys = np.asarray(keys, np.uint64)
        self.lookups += keys.size
        out = np.full(keys.size, -1, np.int64)
        if self.keys.size:
            idx = self.plex.lookup(keys)
            ok = (idx < self.keys.size) & (self.keys[np.minimum(
                idx, self.keys.size - 1)] == keys)
            out[ok] = self.vals[idx[ok]]
        if self.overlay:
            for i, k in enumerate(keys):
                v = self.overlay.get(int(k))
                if v is not None:
                    out[i] = v
        return out


@dataclasses.dataclass
class PagedKVStore:
    """Physical page pool + PLEX page table (host-side swap tier).

    Live decode slots use contiguous device cache; sequences that pause or
    finish have their cache pages swapped here and restored on resume —
    the vLLM-style swap tier, with PLEX doing the page translation."""
    page_tokens: int
    n_pages: int

    def __post_init__(self):
        self.pool: dict[int, np.ndarray] = {}
        self.free = list(range(self.n_pages - 1, -1, -1))
        self.table = PageTable()

    def store(self, seq_id: int, kv: np.ndarray) -> int:
        """kv [T, ...] -> paged copies; returns #pages used."""
        t = kv.shape[0]
        n = (t + self.page_tokens - 1) // self.page_tokens
        if n > len(self.free):
            raise MemoryError("KV pool exhausted")
        pages = [self.free.pop() for _ in range(n)]
        for i, p in enumerate(pages):
            chunk = kv[i * self.page_tokens:(i + 1) * self.page_tokens]
            self.pool[p] = np.ascontiguousarray(chunk)
        self.table.insert(page_key(seq_id, np.arange(n)),
                          np.asarray(pages))
        return n

    def fetch(self, seq_id: int, n_tokens: int) -> np.ndarray:
        n = (n_tokens + self.page_tokens - 1) // self.page_tokens
        phys = self.table.lookup(page_key(seq_id, np.arange(n)))
        if (phys < 0).any():
            raise KeyError(f"seq {seq_id} not fully mapped")
        out = np.concatenate([self.pool[int(p)] for p in phys], axis=0)
        return out[:n_tokens]

    def release(self, seq_id: int, n_tokens: int) -> None:
        n = (n_tokens + self.page_tokens - 1) // self.page_tokens
        keys = page_key(seq_id, np.arange(n))
        phys = self.table.lookup(keys)
        for p in phys[phys >= 0]:
            self.pool.pop(int(p), None)
            self.free.append(int(p))
        self.table.remove(keys)
