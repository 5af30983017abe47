"""Array-packed static B+-tree (cache-line nodes), the classical baseline.

Every ``fanout``-th key of a level is promoted to the level above; lookup
descends with one ``fanout``-wide bounded search per level. Size counts the
internal levels only (leaves are the data itself), matching how the paper
sizes index structures.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BTree:
    keys: np.ndarray
    levels: list[np.ndarray]      # top (smallest) first
    fanout: int
    name: str = "BTree"

    @property
    def size_bytes(self) -> int:
        return int(sum(8 * lv.size for lv in self.levels))

    def lookup(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        if not self.levels:
            return np.searchsorted(self.keys, q, side="left")
        # lower-bound position within the (small) top level
        pos = np.searchsorted(self.levels[0], q, side="left").astype(np.int64)
        for nxt in self.levels[1:] + [self.keys]:
            # predecessor's children span [start, start+fanout]; the lower
            # bound of q in this level lies inside that inclusive window
            start = np.maximum(pos - 1, 0) * self.fanout
            idx = start[:, None] + np.arange(self.fanout + 1)
            valid = idx < nxt.size
            w = nxt[np.minimum(idx, nxt.size - 1)]
            pos = start + np.sum((w < q[:, None]) & valid, axis=1)
        return pos


def build_btree(keys: np.ndarray, fanout: int = 16) -> BTree:
    keys = np.asarray(keys, dtype=np.uint64)
    levels: list[np.ndarray] = []
    cur = keys
    while cur.size > fanout:
        cur = cur[::fanout].copy()
        levels.append(cur)
    levels.reverse()
    return BTree(keys=keys, levels=levels, fanout=fanout)
