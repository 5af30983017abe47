"""Standalone CHT index baseline (Crotty 2021): CHT directly over the data.

Indexes the *unique data keys* themselves (no spline), answering with a
delta-bounded window. Like the paper's implementation, it does not support
duplicate keys (the wiki case) — ``build_cht_index`` raises, reproducing the
limitation the paper calls out; PLEX avoids it because spline keys are unique.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..cht import CHT, build_cht
from ..plex import bounded_lower_bound


class DuplicateKeysError(ValueError):
    pass


@dataclasses.dataclass
class CHTIndex:
    cht: CHT
    keys: np.ndarray
    name: str = "CHT"

    @property
    def size_bytes(self) -> int:
        return self.cht.size_bytes

    def lookup(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        qt = self.cht.lookup(q)
        hi = np.minimum(qt + self.cht.delta, self.keys.size - 1)
        return bounded_lower_bound(self.keys, q, qt, hi, side="left")


def build_cht_index(keys: np.ndarray, r: int = 8,
                    delta: int = 64) -> CHTIndex:
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if np.any(keys[1:] == keys[:-1]):
        raise DuplicateKeysError(
            "CHT does not support duplicate keys (paper §4: the wiki dataset)")
    return CHTIndex(cht=build_cht(keys, r, delta), keys=keys)
