"""The search window around a predicted rank, shared by the learned
baselines (``PGMIndex``, ``RadixSpline``, ``RMI``)."""
from __future__ import annotations

import numpy as np

from ..plex import bounded_lower_bound


def predicted_window(pred: np.ndarray, err_lo, err_hi, n: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive window ``[floor(pred) - err_lo, ceil(pred) + err_hi]``
    clipped to ``[0, n - 1]``. The prediction is clipped to ``[0, n - 1]``
    before its int64 cast, as ``PLEX.lookup`` does (ROADMAP queue 3, R2):
    the window moves only where the reference's cast overflows, a key far
    past the end."""
    pred = np.clip(pred, 0, n - 1)
    lo = np.clip(np.floor(pred).astype(np.int64) - err_lo, 0, n - 1)
    hi = np.clip(np.ceil(pred).astype(np.int64) + err_hi, 0, n - 1)
    return lo, hi


def window_lower_bound(keys: np.ndarray, q: np.ndarray, lo: np.ndarray,
                       hi: np.ndarray) -> np.ndarray:
    """First index with ``keys[i] >= q``, searched in ``[lo, hi]``.

    The window holds the answer of every present key; an absent key's can
    miss it (ROADMAP queue 3, R9: past the last key of an RMI leaf, or
    past a run of duplicates). A lane whose window is not conclusive (the
    key before its answer is ``>= q``, or the key at it ``< q``) is answered
    by a binary search over the whole array, so every answer is the lower
    bound and every answer the reference gets right is unchanged."""
    out = bounded_lower_bound(keys, q, lo, hi, side="left")
    before = (out == lo) & (lo > 0)
    before[before] = keys[lo[before] - 1] >= q[before]
    after = (out == hi + 1) & (out < keys.size)
    after[after] = keys[out[after]] < q[after]
    miss = before | after
    if miss.any():
        out[miss] = np.searchsorted(keys, q[miss], side="left")
    return out
