"""RadixSpline baseline (Kipf et al. 2020): eps-spline + fixed-r radix table.

Identical to PLEX except the radix layer is a flat table whose ``r`` is a
*hyperparameter* (no auto-tuning, no CHT option) — this is what exposes RS to
the outlier problem the paper demonstrates on ``face``. The prediction takes
the exact 64-bit key difference (``Spline.predict_in_segment``, R1), and an
absent key whose window is not conclusive is answered by a full binary
search (``window_lower_bound``, R9).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..plex import bounded_lower_bound
from ..radix_table import RadixTable, build_radix_table
from ..spline import Spline, build_spline
from ._window import predicted_window, window_lower_bound


@dataclasses.dataclass
class RadixSpline:
    spline: Spline
    table: RadixTable
    keys: np.ndarray
    eps: int
    name: str = "RadixSpline"

    @property
    def size_bytes(self) -> int:
        return self.spline.size_bytes + self.table.size_bytes

    def predict(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        lo, hi = self.table.lookup(q)
        seg = bounded_lower_bound(self.spline.keys, q, lo, hi, side="right")
        seg = np.clip(seg, 0, self.spline.keys.size - 2)
        return self.spline.predict_in_segment(q, seg)

    def lookup(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        lo, hi = predicted_window(self.predict(q), self.eps, self.eps,
                                  self.keys.size)
        return window_lower_bound(self.keys, q, lo, hi)


def build_radixspline(keys: np.ndarray, eps: int, r: int = 18) -> RadixSpline:
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    spline = build_spline(keys, eps)
    table = build_radix_table(spline.keys, r)
    return RadixSpline(spline=spline, table=table, keys=keys, eps=eps)
