"""Flat radix table over spline keys (RadixSpline's layer; PLEX's fallback).

Host build and host lookup of the port, identical to
``repro.core.radix_table``; the table is read on the device by
``repro_torch.kernels.stacked_lookup`` and ``segment_lookup``.

``table[p]`` = index of the first spline key whose prefix is >= p, where the
prefix is the top ``r`` bits of ``key - min_key`` within the key range's
``range_bits``. The true predecessor index of a query with prefix ``p`` lies in
``[max(table[p]-1, 0), max(table[p+1]-1, 0)]`` (the -1 covers queries below the
first key of their bucket; a radix table has no global error bound, which is
exactly why the paper needs a separate cost model for it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cht import bit_length_u64


@dataclasses.dataclass
class RadixTable:
    r: int
    min_key: np.uint64
    shift: int               # range_bits - r (>=0)
    table: np.ndarray        # uint32 [2**r + 1]
    n_keys: int

    @property
    def size_bytes(self) -> int:
        return 4 * self.table.size

    @property
    def max_window(self) -> int:
        d = np.diff(self.table.astype(np.int64))
        return int(d.max()) + 1 if d.size else 1

    def prefixes(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        rel = np.where(q > self.min_key, q - self.min_key, np.uint64(0))
        return (rel >> np.uint64(self.shift)).astype(np.int64)

    def lookup(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) inclusive window of candidate predecessor indices."""
        p = np.clip(self.prefixes(q), 0, (1 << self.r) - 1)
        lo = np.maximum(self.table[p].astype(np.int64) - 1, 0)
        hi = np.maximum(self.table[p + 1].astype(np.int64) - 1, 0)
        return lo, hi


def range_bits(keys: np.ndarray) -> int:
    span = np.uint64(keys[-1]) - np.uint64(keys[0])
    return max(int(bit_length_u64(np.asarray([span]))[0]), 1)


def build_radix_table(keys: np.ndarray, r: int) -> RadixTable:
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size == 0:
        raise ValueError("empty key set")
    bits = range_bits(keys)
    r = min(r, bits)
    shift = bits - r
    prefix = (keys - keys[0]) >> np.uint64(shift)
    table = np.searchsorted(prefix, np.arange((1 << r) + 1, dtype=np.uint64),
                            side="left").astype(np.uint32)
    return RadixTable(r=r, min_key=keys[0], shift=shift, table=table,
                      n_keys=keys.size)
