"""Binary search over the raw key array — the zero-size baseline."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BinarySearch:
    keys: np.ndarray
    name: str = "BinarySearch"

    @property
    def size_bytes(self) -> int:
        return 0

    def lookup(self, q: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.keys, np.asarray(q, dtype=np.uint64),
                               side="left")


def build_binary_search(keys: np.ndarray) -> BinarySearch:
    return BinarySearch(keys=np.asarray(keys, dtype=np.uint64))
