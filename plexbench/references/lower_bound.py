"""The plain reference of a PLEX lookup: each query's first-occurrence rank
in the sorted key array, ``np.searchsorted(keys, q, "left")``.

The queries are searched in their sorted order: the same answers, but each
search starts where the last one ended, so ascending queries stay in cache
(several times faster over 200M keys).
"""
from __future__ import annotations

import numpy as np


def ranks(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """int64 lower-bound ranks of the uint64 queries ``q`` in the sorted
    uint64 ``keys``."""
    order = np.argsort(q, kind="stable")
    out = np.empty(q.size, dtype=np.int64)
    out[order] = np.searchsorted(keys, q[order], side="left")
    return out
