"""LearnedIndex + Snapshot — lookup dispatch and the immutable sharded index.

``LearnedIndex`` is the port's counterpart of ``repro.core.index.
LearnedIndex``: one PLEX over one sorted key array, looked up through a
backend resolved by the registry (``kernels.backends``):

* ``"cuda"`` (the default) — ``kernels.ops.DevicePlex`` on the index's
  device: K2/K3 fused with K4's probe, one launch per call on a CUDA card
  (the plain PyTorch pipeline on ``device="cpu"``);
* ``"torch"`` — the same pipeline's plain PyTorch version, on any device;
* ``"numpy"`` — the host ``PLEX.lookup``.

    idx = LearnedIndex.build(keys, eps=64)      # device defaults to CUDA
    idx.lookup(q)                               # "cuda"
    idx.lookup(q, backend="numpy")

``Snapshot`` is the port's counterpart of ``repro.core.index.Snapshot``: the
sorted key array, the per-shard frozen ``PLEX`` indexes (shard boundaries
snapped to first occurrences), the shard-minima routing plane, and — lazily
— the fused shard-major stacked device layout, cached per backend and
configuration, its device planes built once per device and shared by every
backend's impl (``cuda`` launches K1 on them, ``torch`` runs the plain
pipeline on the same tensors). Once built a snapshot never changes (every
host array is frozen), so an updatable service can swap in a new one with a
single reference assignment while readers of the old one finish
undisturbed.
``Snapshot.save``/``Snapshot.load`` persist it as one generation of the
reference's on-disk format (``persist.format``); a loaded snapshot hands its
mapped planes and persisted statics to the first stacked build of each
shard range through ``host_planes_fn`` (the reference's warm-start hook).

``Snapshot.build(workers=N)`` fans the per-shard builds over a process
pool (``core.parallel_build``), bit-identical to the serial build.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Sequence

import numpy as np

from ..device import resolve_device
from ..kernels.backends import BACKENDS, get_backend
from .plex import PLEX, BuildStats, build_plex, freeze_arrays

# keep each shard's float32 rank plane well inside the 2^24 limit
SHARD_MAX_KEYS = 1 << 23

__all__ = ["BACKENDS", "LearnedIndex", "SHARD_MAX_KEYS", "Snapshot",
           "shard_offsets"]


@dataclasses.dataclass
class LearnedIndex:
    """One PLEX with lazily built, cached device impls (see the module
    docstring). ``device`` is resolved at construction: the CUDA card unless
    the caller passes another."""
    plex: PLEX
    block: int = 512
    device: Any = None
    default_backend: str = "cuda"
    _impls: dict = dataclasses.field(default_factory=dict, repr=False)
    _stacked_impls: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    def __post_init__(self) -> None:
        if self.block % 128 != 0 or self.block <= 0:
            raise ValueError("block must be a positive multiple of 128")
        get_backend(self.default_backend)     # fail unknown names early
        self.device = resolve_device(self.device)

    @classmethod
    def build(cls, keys: np.ndarray, eps: int, *, backend: str = "cuda",
              block: int = 512, device=None, **build_kw) -> "LearnedIndex":
        """Build the underlying PLEX (host-side, the paper's single-pass
        build) and wrap it for dispatch."""
        return cls(plex=build_plex(keys, eps, **build_kw), block=block,
                   device=device, default_backend=backend)

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

    @property
    def stats(self) -> BuildStats:
        return self.plex.stats

    @property
    def name(self) -> str:
        return "LearnedIndex"

    # -- dispatch ------------------------------------------------------------
    def backend_impl(self, backend: str | None = None):
        """The (lazily constructed, cached) implementation for ``backend``,
        resolved through the registry: the host ``PLEX`` for a host backend,
        the backend's index impl (a ``DevicePlex`` for ``cuda`` and
        ``torch``) otherwise."""
        backend = backend or self.default_backend
        spec = get_backend(backend)
        impl = self._impls.get(backend)
        if impl is None:
            impl = (self.plex if spec.host else
                    spec.index_factory(self.plex, block=self.block,
                                       device=self.device))
            self._impls[backend] = impl
        return impl

    def stacked_impl(self, backend: str | None = None, *,
                     probe: str | None = None, cache_slots: int = 0):
        """The single-shard stacked impl (a ``StackedTorchPlex``, the
        serving path's fused pipeline) of this index on its device for
        ``backend``, cached per configuration. A lone shard always unifies,
        so this is never ``None``; host backends have no device path and
        raise."""
        backend = backend or self.default_backend
        spec = get_backend(backend)
        if spec.stacked_factory is None:
            raise ValueError(
                f"backend {backend!r} has no stacked device path")
        cfg = (backend, probe, int(cache_slots))
        impl = self._stacked_impls.get(cfg)
        if impl is None:
            impl = spec.stacked_factory(
                [self.plex], np.zeros(1, dtype=np.int64), device=self.device,
                block=self.block, probe=probe, cache_slots=cache_slots,
                host_planes=None, summary_keys=None)
            self._stacked_impls[cfg] = impl
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
    caller of ``stacked_impl`` asks for another one. A snapshot loaded from
    disk (``Snapshot.load``) may be a partial view of its generation
    (``persist.format.load_snapshot(shard_range=...)``): ``keys`` and
    ``offsets`` are then rebased to the local slice, and ``shard_base`` /
    ``key_base`` record the view's global position. ``mapped_bytes`` is
    what the loader mapped (0 for a built snapshot).
    """

    shard_base: int = 0
    key_base: int = 0
    mapped_bytes: int = 0

    def __init__(self, keys: np.ndarray, eps: int, offsets: np.ndarray,
                 shards: Sequence[PLEX], *, device=None, build_s: float = 0.0,
                 epoch: int = 0, host_planes_fn: Callable | None = None):
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
        # (backend, [shard,] device, block, probe[, cache_slots]) -> impl |
        # None
        self._stacked: dict = {}
        # (device, shard or None) -> the StackedPlanes the impls of those
        # shards share (the first impl's), whatever their backend
        self._planes: dict = {}
        # the warm-start hook of a loaded snapshot: ``fn(lo, hi)`` gives
        # shards [lo, hi)'s ``_HostPlanes`` from the mapped file. Called
        # once a shard range and device (its planes are then shared) and
        # not cached: the device planes are the copies kept, and pinning
        # host copies too would double resident memory
        self._host_planes_fn = host_planes_fn

    @classmethod
    def build(cls, keys: np.ndarray, eps: int, *, n_shards: int | None = None,
              device=None, epoch: int = 0, workers: int | None = None,
              pool: str = "process", mp_context: Any = None,
              **build_kw) -> "Snapshot":
        """Host-side sharded build (the paper's single-pass build per shard).

        ``workers > 1`` fans the independent per-shard ``build_plex`` calls
        over a process pool (``core.parallel_build``): the keys reach the
        workers by memmap, copy-on-write fork or a scratch file, never
        pickled, and the result is bit-identical to the serial build. Fork
        is the start method until this process has initialised CUDA, spawn
        after (``mp_context`` overrides); ``pool="thread"`` uses threads.
        Per-shard phase timings are summed in ``build_stats``.

        The key array is adopted and frozen in place rather than copied (at
        200M keys a defensive copy would double resident memory)."""
        from ..obs.trace import TRACE
        from .parallel_build import build_shard_plexes
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
        plexes = build_shard_plexes(
            keys, offsets, eps, workers=int(workers or 1), pool=pool,
            mp_context=mp_context, **build_kw)
        snap = cls(keys, eps, offsets, plexes, device=device,
                   build_s=time.perf_counter() - t0, epoch=epoch)
        if TRACE.enabled:
            bs = snap.build_stats
            TRACE.record("build.spline", bs.spline_s, shards=len(plexes))
            TRACE.record("build.tune", bs.tune_s, shards=len(plexes))
            TRACE.record("build.layer", bs.layer_s, shards=len(plexes))
        return snap

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def build_stats(self) -> BuildStats:
        """Per-phase build timings summed over the shards (seconds of index
        work; ``build_stats.total_s / build_s`` is the realised build
        parallelism). Loaded snapshots report zeros."""
        return BuildStats.aggregate([px.stats for px in self.shards])

    @property
    def n_keys(self) -> int:
        return int(self.keys.size)

    @property
    def size_bytes(self) -> int:
        """The shards' index bytes (spline + layer), the paper's size
        metric summed over the shards."""
        return sum(px.size_bytes for px in self.shards)

    @property
    def name(self) -> str:
        return "Snapshot"

    @functools.cached_property
    def indexes(self) -> tuple[LearnedIndex, ...]:
        """Each shard's PLEX as a ``LearnedIndex`` on this snapshot's device
        (the reference's ``Snapshot.shards``: per-shard ``keys``, ``eps``,
        ``size_bytes``, ``stats``), wrapped once, with no rebuild."""
        return tuple(LearnedIndex(plex=px, device=self.device)
                     for px in self.shards)

    def route(self, q: np.ndarray) -> np.ndarray:
        """Shard id per query (largest shard whose min key is <= q)."""
        q = np.asarray(q, dtype=np.uint64)
        return np.clip(np.searchsorted(self.shard_min, q, side="right") - 1,
                       0, self.n_shards - 1)

    def _stacked_factory(self, backend: str):
        spec = get_backend(backend)
        if spec.stacked_factory is None:
            raise ValueError(
                f"backend {backend!r} has no stacked device path")
        return spec.stacked_factory

    def stacked_impl(self, backend: str = "cuda", *, device=None,
                     block: int = 512, probe: str | None = None,
                     cache_slots: int = 0):
        """The fused shard-major stacked path of this snapshot on
        ``backend`` (resolved through the registry; for ``cuda`` and
        ``torch`` a ``StackedTorchPlex`` with a hot-key cache of
        ``cache_slots`` slots, a power of two or 0), or ``None`` when the
        shards' static parameters cannot be unified. Cached per
        configuration, ``None`` results included."""
        from ..kernels.stacked_lookup import check_cache_slots
        factory = self._stacked_factory(backend)
        check_cache_slots(cache_slots)
        dev = self.device if device is None else resolve_device(device)
        cfg = (backend, dev, int(block), probe, int(cache_slots))
        if cfg not in self._stacked:
            self._stacked[cfg] = self._build_impl(
                factory, (dev, None), self.shards, self.offsets, (),
                device=dev, block=block, probe=probe,
                cache_slots=cache_slots)
        return self._stacked[cfg]

    def _build_impl(self, factory, pkey, plexes, row_off, span, **kw):
        """One stacked impl through ``factory`` on the planes the impls of
        the same shards and device already share (``pkey``), built from
        the mapped file's host planes (shards ``span``) when a loaded
        snapshot has none yet. Backends that differ only in their route
        (K1 or its plain version) thus hold one copy of the planes."""
        from ..kernels.planes import StackedPlanes
        planes = self._planes.get(pkey)
        hps = (self._host_planes_fn(*span)
               if planes is None and self._host_planes_fn is not None
               else None)
        impl = factory(plexes, row_off, host_planes=hps,
                       summary_keys=self.n_keys, planes=planes, **kw)
        if planes is None and isinstance(getattr(impl, "planes", None),
                                         StackedPlanes):
            self._planes[pkey] = impl.planes
        return impl

    def shard_impl(self, s: int, backend: str = "cuda", *, device=None,
                   block: int = 512, probe: str | None = None):
        """Single-shard stacked impl of shard ``s`` on ``backend`` (row
        offset 0; a lone shard always unifies) — the per-shard path when
        ``stacked_impl`` is ``None``. Cached per configuration. Every
        shard's planes share the card, so the key summary's levels follow
        the whole snapshot's size."""
        factory = self._stacked_factory(backend)
        dev = self.device if device is None else resolve_device(device)
        cfg = (backend, int(s), dev, int(block), probe)
        if cfg not in self._stacked:
            self._stacked[cfg] = self._build_impl(
                factory, (dev, int(s)), [self.shards[s]],
                np.zeros(1, dtype=np.int64), (s, s + 1), device=dev,
                block=block, probe=probe, cache_slots=0)
        return self._stacked[cfg]

    # -- durability (``persist``) ---------------------------------------------
    def save(self, gen_dir, *, fsync: bool = True):
        """Serialise this snapshot into ``gen_dir`` (one generation of the
        on-disk format, ``persist.format``). Standalone use only: a durable
        ``PlexService`` manages generations and the manifest itself."""
        from ..persist.format import save_snapshot
        return save_snapshot(gen_dir, self, fsync=fsync)

    @classmethod
    def load(cls, gen_dir, *, verify: bool = False,
             device=None) -> "Snapshot":
        """Map one persisted generation back into an immutable snapshot
        whose planes go to ``device`` (no index rebuild;
        ``persist.format.load_snapshot``)."""
        from ..persist.format import load_snapshot
        return load_snapshot(gen_dir, verify=verify, device=device)
