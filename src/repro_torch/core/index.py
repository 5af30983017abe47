"""Snapshot — the immutable sharded index the device pipeline serves.

The port's counterpart of ``repro.core.index.Snapshot``: the sorted key
array, the per-shard frozen ``PLEX`` indexes (shard boundaries snapped to
first occurrences), the shard-minima routing plane, and — lazily — the fused
shard-major stacked device layout, cached per configuration. Once built a
snapshot never changes (every host array is frozen), so an updatable service
can swap in a new one with a single reference assignment while readers of
the old one finish undisturbed.

The build is serial here; the process-pool build of the reference
(``repro.core.parallel_build``) is a later slice of the port.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from ..device import resolve_device
from .plex import PLEX, build_plex, freeze_arrays

# keep each shard's float32 rank plane well inside the 2^24 limit
SHARD_MAX_KEYS = 1 << 23


def shard_offsets(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous shard start offsets, snapped to first occurrences so a
    duplicate run never straddles a boundary (global first-occurrence
    semantics stay exact)."""
    raw = (np.arange(n_shards, dtype=np.int64) * keys.size) // n_shards
    snapped = np.searchsorted(keys, keys[raw], side="left")
    snapped[0] = 0
    return np.unique(snapped)


class Snapshot:
    """Immutable sharded index state: keys + frozen per-shard PLEX + planes.

    ``device`` is where the stacked planes of this snapshot live unless a
    caller of ``stacked_impl`` asks for another one.
    """

    def __init__(self, keys: np.ndarray, eps: int, offsets: np.ndarray,
                 shards: Sequence[PLEX], *, device=None, build_s: float = 0.0):
        self.device = resolve_device(device)
        self.keys = keys
        self.eps = int(eps)
        self.offsets = offsets
        self.shards = tuple(shards)
        self.shard_min = keys[offsets].copy()
        self.build_s = float(build_s)
        freeze_arrays(self.keys, self.offsets, self.shard_min)
        for px in self.shards:
            px.freeze()
        # ([shard,] device, block, probe) -> impl | None
        self._stacked: dict = {}

    @classmethod
    def build(cls, keys: np.ndarray, eps: int, *, n_shards: int | None = None,
              device=None, **build_kw) -> "Snapshot":
        """Host-side sharded build (the paper's single-pass build per shard).

        The key array is adopted and frozen in place rather than copied (at
        200M keys a defensive copy would double resident memory)."""
        device = resolve_device(device)
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.size == 0:
            raise ValueError("cannot snapshot an empty key set")
        if np.any(keys[1:] < keys[:-1]):
            raise ValueError("keys must be sorted")
        if n_shards is None:
            n_shards = -(-keys.size // SHARD_MAX_KEYS)
        offsets = shard_offsets(keys, max(int(n_shards), 1))
        t0 = time.perf_counter()
        ends = np.append(offsets[1:], keys.size)
        plexes = [build_plex(keys[lo:hi], eps, **build_kw)
                  for lo, hi in zip(offsets, ends)]
        return cls(keys, eps, offsets, plexes, device=device,
                   build_s=time.perf_counter() - t0)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_keys(self) -> int:
        return int(self.keys.size)

    def route(self, q: np.ndarray) -> np.ndarray:
        """Shard id per query (largest shard whose min key is <= q)."""
        q = np.asarray(q, dtype=np.uint64)
        return np.clip(np.searchsorted(self.shard_min, q, side="right") - 1,
                       0, self.n_shards - 1)

    def stacked_impl(self, *, device=None, block: int = 512,
                     probe: str | None = None):
        """The fused shard-major stacked path of this snapshot
        (``kernels.stacked_lookup.StackedTorchPlex``), or ``None`` when the
        shards' static parameters cannot be unified. Cached per
        configuration, ``None`` results included."""
        from ..kernels.stacked_lookup import StackedTorchPlex
        dev = self.device if device is None else resolve_device(device)
        cfg = (dev, int(block), probe)
        if cfg not in self._stacked:
            self._stacked[cfg] = StackedTorchPlex.from_plexes(
                self.shards, self.offsets, device=dev, block=block,
                probe=probe)
        return self._stacked[cfg]

    def shard_impl(self, s: int, *, device=None, block: int = 512,
                   probe: str | None = None):
        """Single-shard stacked impl of shard ``s`` (row offset 0; a lone
        shard always unifies) — the per-shard path when ``stacked_impl``
        is ``None``. Cached per configuration."""
        from ..kernels.stacked_lookup import StackedTorchPlex
        dev = self.device if device is None else resolve_device(device)
        cfg = (int(s), dev, int(block), probe)
        if cfg not in self._stacked:
            self._stacked[cfg] = StackedTorchPlex.from_plexes(
                [self.shards[s]], np.zeros(1, dtype=np.int64), device=dev,
                block=block, probe=probe)
        return self._stacked[cfg]
