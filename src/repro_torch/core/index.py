"""LearnedIndex + Snapshot — lookup dispatch and the immutable sharded index.

``LearnedIndex`` is the port's counterpart of ``repro.core.index.
LearnedIndex``: one PLEX over one sorted key array, looked up through one of
two backends, resolved by the plain mapping ``BACKENDS`` (the reference's
registry is a later slice of the port):

* ``"cuda"`` (the default) — ``kernels.ops.DevicePlex`` on the index's
  device: the K2/K3 segment lookup and the K4 probe, one launch each per
  call on a CUDA card (the plain PyTorch pipeline on ``device="cpu"``);
* ``"numpy"`` — the host ``PLEX.lookup``.

    idx = LearnedIndex.build(keys, eps=64)      # device defaults to CUDA
    idx.lookup(q)                               # "cuda"
    idx.lookup(q, backend="numpy")

``Snapshot`` is the port's counterpart of ``repro.core.index.Snapshot``: the
sorted key array, the per-shard frozen ``PLEX`` indexes (shard boundaries
snapped to first occurrences), the shard-minima routing plane, and — lazily
— the fused shard-major stacked device layout, cached per configuration.
Once built a snapshot never changes (every host array is frozen), so an
updatable service can swap in a new one with a single reference assignment
while readers of the old one finish undisturbed.

The build is serial here; the process-pool build of the reference
(``repro.core.parallel_build``) is a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from .plex import PLEX, build_plex, freeze_arrays

# keep each shard's float32 rank plane well inside the 2^24 limit
SHARD_MAX_KEYS = 1 << 23
# backend name -> whether it serves from the host PLEX (no device impl)
BACKENDS = {"cuda": False, "numpy": True}


def _check_backend(name: str) -> bool:
    """Whether ``name`` is a host backend; unknown names raise."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(repr(n) for n in BACKENDS)}") from None


@dataclasses.dataclass
class LearnedIndex:
    """One PLEX with lazily built, cached device impls (see the module
    docstring). ``device`` is resolved at construction: the CUDA card unless
    the caller passes another."""
    plex: PLEX
    block: int = 512
    device: Any = None
    _impls: dict = dataclasses.field(default_factory=dict, repr=False)
    _stacked_impls: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    def __post_init__(self) -> None:
        if self.block % 128 != 0 or self.block <= 0:
            raise ValueError("block must be a positive multiple of 128")
        self.device = resolve_device(self.device)

    @classmethod
    def build(cls, keys: np.ndarray, eps: int, *, block: int = 512,
              device=None, **build_kw) -> "LearnedIndex":
        """Build the underlying PLEX (host-side, the paper's single-pass
        build) and wrap it for dispatch."""
        return cls(plex=build_plex(keys, eps, **build_kw), block=block,
                   device=device)

    # -- passthrough metadata ------------------------------------------------
    @property
    def keys(self) -> np.ndarray:
        return self.plex.keys

    @property
    def eps(self) -> int:
        return self.plex.eps

    @property
    def size_bytes(self) -> int:
        return self.plex.size_bytes

    # -- dispatch ------------------------------------------------------------
    def backend_impl(self, backend: str | None = None):
        """The (lazily constructed, cached) implementation for ``backend``:
        the host ``PLEX`` for ``"numpy"``, a ``DevicePlex`` for ``"cuda"``
        (the default)."""
        backend = backend or "cuda"
        if _check_backend(backend):
            return self.plex
        impl = self._impls.get(backend)
        if impl is None:
            from ..kernels.ops import DevicePlex
            impl = DevicePlex.from_plex(self.plex, block=self.block,
                                        device=self.device)
            self._impls[backend] = impl
        return impl

    def stacked_impl(self, *, probe: str | None = None):
        """The single-shard stacked impl (``StackedTorchPlex``, the serving
        path's fused kernel) of this index on its device, cached per probe
        mode. A lone shard always unifies, so this is never ``None``."""
        impl = self._stacked_impls.get(probe)
        if impl is None:
            from ..kernels.stacked_lookup import StackedTorchPlex
            impl = StackedTorchPlex.from_plexes(
                [self.plex], np.zeros(1, dtype=np.int64), device=self.device,
                block=self.block, probe=probe)
            self._stacked_impls[probe] = impl
        return impl

    def warmup(self, backend: str | None = None) -> None:
        """Build the backend's impl and run one block-sized lookup (on a
        card this also builds and loads the kernels)."""
        impl = self.backend_impl(backend)
        if impl is not self.plex:
            impl.lookup(self.plex.keys[:1])

    def lookup(self, q: np.ndarray, backend: str | None = None) -> np.ndarray:
        """First-occurrence index per query key (``PLEX.lookup`` contract)."""
        return self.backend_impl(backend).lookup(q)


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
                 shards: Sequence[PLEX], *, device=None, build_s: float = 0.0,
                 epoch: int = 0):
        self.device = resolve_device(device)
        self.keys = keys
        self.eps = int(eps)
        self.offsets = offsets
        self.shards = tuple(shards)
        self.shard_min = keys[offsets].copy()
        self.build_s = float(build_s)
        self.epoch = int(epoch)   # the merge count that produced it
        freeze_arrays(self.keys, self.offsets, self.shard_min)
        for px in self.shards:
            px.freeze()
        # ([shard,] device, block, probe[, cache_slots]) -> impl | None
        self._stacked: dict = {}

    @classmethod
    def build(cls, keys: np.ndarray, eps: int, *, n_shards: int | None = None,
              device=None, epoch: int = 0, **build_kw) -> "Snapshot":
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
                   build_s=time.perf_counter() - t0, epoch=epoch)

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
                     probe: str | None = None, cache_slots: int = 0):
        """The fused shard-major stacked path of this snapshot
        (``kernels.stacked_lookup.StackedTorchPlex``, with a hot-key cache
        of ``cache_slots`` slots, a power of two or 0), or ``None`` when the
        shards' static parameters cannot be unified. Cached per
        configuration, ``None`` results included."""
        from ..kernels.stacked_lookup import StackedTorchPlex, \
            check_cache_slots
        check_cache_slots(cache_slots)
        dev = self.device if device is None else resolve_device(device)
        cfg = (dev, int(block), probe, int(cache_slots))
        if cfg not in self._stacked:
            self._stacked[cfg] = StackedTorchPlex.from_plexes(
                self.shards, self.offsets, device=dev, block=block,
                probe=probe, cache_slots=cache_slots,
                summary_keys=self.n_keys)
        return self._stacked[cfg]

    def shard_impl(self, s: int, *, device=None, block: int = 512,
                   probe: str | None = None):
        """Single-shard stacked impl of shard ``s`` (row offset 0; a lone
        shard always unifies) — the per-shard path when ``stacked_impl``
        is ``None``. Cached per configuration. Every shard's planes share
        the card, so the key summary's levels follow the whole snapshot's
        size."""
        from ..kernels.stacked_lookup import StackedTorchPlex
        dev = self.device if device is None else resolve_device(device)
        cfg = (int(s), dev, int(block), probe)
        if cfg not in self._stacked:
            self._stacked[cfg] = StackedTorchPlex.from_plexes(
                [self.shards[s]], np.zeros(1, dtype=np.int64), device=dev,
                block=block, probe=probe, summary_keys=self.n_keys)
        return self._stacked[cfg]
