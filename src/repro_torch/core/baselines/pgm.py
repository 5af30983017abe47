"""PGM-index baseline (Ferragina & Vinciguerra 2020): recursive eps-PLA.

Each level is an eps-bounded piecewise-linear approximation of the level
below; we reuse the greedy corridor builder (an eps-PLA with at most 2x the
optimal segment count — PGM uses the optimal O(N) algorithm, same
asymptotics). Lookup descends level by level, each step a bounded binary
search within +-eps. ``Spline.predict_in_segment`` takes the exact 64-bit key
difference (R1), so below 2^53 the prediction equals the reference's bit for
bit and above it the lookup stays exact; an absent key whose final window is
not conclusive is answered by a full binary search (``window_lower_bound``,
R9).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..plex import bounded_lower_bound
from ..spline import Spline, build_spline
from ._window import predicted_window, window_lower_bound


@dataclasses.dataclass
class PGMIndex:
    keys: np.ndarray
    levels: list[Spline]      # bottom (largest, over the data) first
    eps: int
    name: str = "PGM"

    @property
    def size_bytes(self) -> int:
        return int(sum(lv.size_bytes for lv in self.levels))

    def lookup(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        # search window within the current level's key array; the top level is
        # small so its window is the whole level
        lo = np.zeros(q.size, dtype=np.int64)
        hi = np.full(q.size, self.levels[-1].keys.size - 1, dtype=np.int64)
        for i in range(len(self.levels) - 1, -1, -1):
            lv = self.levels[i]
            seg = bounded_lower_bound(lv.keys, q, lo, hi, side="right")
            seg = np.clip(seg, 0, lv.keys.size - 2)
            pred = lv.predict_in_segment(q, seg)
            below = self.keys.size if i == 0 else self.levels[i - 1].keys.size
            lo, hi = predicted_window(pred, self.eps, self.eps, below)
        return window_lower_bound(self.keys, q, lo, hi)


def build_pgm(keys: np.ndarray, eps: int, *, top_threshold: int = 64
              ) -> PGMIndex:
    keys = np.asarray(keys, dtype=np.uint64)
    levels = [build_spline(keys, eps)]
    while levels[-1].keys.size > top_threshold:
        nxt = build_spline(levels[-1].keys, eps)
        # a level that keeps every key below it would repeat forever (the
        # float64 repair pass keeps every point of keys dense above 2^53);
        # it is never reached where the reference's loop ends
        if nxt.keys.size >= levels[-1].keys.size:
            break
        levels.append(nxt)
    return PGMIndex(keys=keys, levels=levels, eps=eps)
