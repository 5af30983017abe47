"""PlexService — serve (and update) PLEX lookups on one device.

The lean port of ``repro.serving.plex_service.PlexService``: a sharded
snapshot built on the host, a delta buffer of inserts and deletes, and one
device dispatch per micro-batch.

* **Fused path.** When the shards unify (``kernels.planes``), each
  ``block``-sized micro-batch is one kernel launch, with the live delta
  folded into the same launch.
* **Per-shard path.** When they do not (mixed radix/CHT shards), queries are
  routed and grouped by shard on the host, uploaded once, and each shard's
  slice runs through a single-shard stacked impl, one launch per
  micro-batch; the host adds the global offsets and the delta adjustment.
* **Overlap.** Within one request's dispatch every launch but the first is
  a programmatic dependent launch on the one before it, so the per-shard
  path's many short launches overlap on the card
  (``kernels.stacked_lookup``).
* ``merge()`` rebuilds the snapshot from the logical key array and swaps it
  in with one reference assignment.

There is no fallback chain: a kernel that fails to build or launch raises
out of ``lookup``. The hot-key cache, counted dispatch, ``submit``/``drain``,
the backend registry, persistence, resilience, the mesh and observability
are later slices of the port (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.index import Snapshot
from ..device import resolve_device
from ..kernels.keys import to_biased
from ..kernels.planes import finalize_indices
from ..kernels.stacked_lookup import PROBE_MODES, StackedTorchPlex
from .delta import DELTA_CAP_MIN, DeltaBuffer, next_pow2

DEFAULT_MERGE_THRESHOLD = 4096


@dataclasses.dataclass
class ServiceStats:
    queries: int = 0
    batches: int = 0          # micro-batches dispatched (one launch each)
    inserts: int = 0
    deletes: int = 0
    merges: int = 0


@dataclasses.dataclass(frozen=True)
class _ServiceState:
    """One consistent (snapshot, delta, fused impl) triple; published by a
    single reference assignment at a merge."""
    snapshot: Snapshot
    delta: DeltaBuffer
    stacked: StackedTorchPlex | None


class PlexService:
    """Serve (and update) PLEX lookups across shards on one device."""

    def __init__(self, keys: np.ndarray, eps: int = 64, *,
                 n_shards: int | None = None, block: int = 512,
                 probe: str | None = None,
                 merge_threshold: int = DEFAULT_MERGE_THRESHOLD,
                 device=None, **build_kw):
        self.device = resolve_device(device)
        if block % 128 != 0:
            raise ValueError("block must be a multiple of 128 lanes")
        if probe is not None and probe not in PROBE_MODES:
            raise ValueError(f"unknown probe mode {probe!r}")
        self.eps = int(eps)
        self.block = int(block)
        self.probe = probe
        self.merge_threshold = int(merge_threshold)
        self.stats = ServiceStats()
        self._n_shards_req = n_shards
        self._build_kw = build_kw
        # the merge threshold bounds the buffer, so the device view is
        # sized to it up front and keeps one capacity per snapshot
        self._delta_capacity = max(
            next_pow2(max(self.merge_threshold, 1)), DELTA_CAP_MIN)
        self._state = self._new_state(keys)     # checks the keys

    def _new_state(self, keys: np.ndarray) -> _ServiceState:
        """Build a snapshot and put its planes on the device: the fused
        planes, or every shard's own when the shards do not unify."""
        snap = Snapshot.build(keys, self.eps, n_shards=self._n_shards_req,
                              device=self.device, **self._build_kw)
        stacked = snap.stacked_impl(block=self.block, probe=self.probe)
        if stacked is None:
            for s in range(snap.n_shards):
                snap.shard_impl(s, block=self.block, probe=self.probe)
        return _ServiceState(
            snap, DeltaBuffer(snap.keys, capacity=self._delta_capacity),
            stacked)

    # -- metadata -----------------------------------------------------------
    @property
    def snapshot(self) -> Snapshot:
        return self._state.snapshot

    @property
    def n_shards(self) -> int:
        return self._state.snapshot.n_shards

    @property
    def fused(self) -> bool:
        """Whether lookups take the fused path (shards unified)."""
        return self._state.stacked is not None

    @property
    def delta(self) -> DeltaBuffer:
        return self._state.delta

    @property
    def n_pending(self) -> int:
        return self._state.delta.n_entries

    def logical_keys(self) -> np.ndarray:
        """The logical key array lookups are answered against (snapshot
        minus tombstones plus pending inserts)."""
        return self._state.delta.logical_keys()

    # -- lookups --------------------------------------------------------------
    def lookup(self, q: np.ndarray) -> np.ndarray:
        """Global first-occurrence index per query key in the *logical*
        (snapshot plus delta) key array."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        state = self._state       # one consistent (snapshot, delta) capture
        self.stats.queries += q.size
        if state.stacked is None:
            return self._lookup_per_shard(state, q)
        delta = (None if state.delta.empty
                 else state.delta.device_view(self.device))
        outs = self._launch(state.stacked, self._upload(q), delta)
        return torch.cat(outs).cpu().numpy().astype(np.int64)

    def _upload(self, q: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(to_biased(q)).to(self.device)

    def _launch(self, st: StackedTorchPlex, qd: torch.Tensor, delta, *,
                chained: bool = False) -> list[torch.Tensor]:
        """``st``'s launches over the device queries ``qd``, one per
        micro-batch, counted in ``stats.batches``; asynchronous.
        ``chained``: a launch of the same dispatch precedes them."""
        outs = st.dispatch(qd, delta, chained=chained)
        self.stats.batches += len(outs)
        return outs

    def _lookup_per_shard(self, state: _ServiceState,
                          q: np.ndarray) -> np.ndarray:
        """Per-shard path: queries grouped by shard on the host (one stable
        sort), one upload, each shard's slice through its single-shard impl
        (one launch per micro-batch, each after the first overlapping the
        one before), one copy back; each shard's clamp and global offset and
        the delta adjustment are folded on the host."""
        snap = state.snapshot
        sid = snap.route(q)
        # shard ids in the narrowest integer type: numpy's stable argsort
        # radix-sorts 8- and 16-bit keys
        order = np.argsort(sid.astype(np.min_scalar_type(snap.n_shards - 1)),
                           kind="stable")
        counts = np.bincount(sid, minlength=snap.n_shards)
        qd = self._upload(q[order])
        outs, start = [], 0
        for s, n in enumerate(counts):
            if n:
                st = snap.shard_impl(s, block=self.block, probe=self.probe)
                outs += self._launch(st, qd[start:start + n], None,
                                     chained=bool(outs))
            start += n
        n_real = np.diff(np.append(snap.offsets, snap.n_keys))
        local = finalize_indices(torch.cat(outs), q.size,
                                 np.repeat(n_real, counts))
        out = np.empty(q.size, dtype=np.int64)
        out[order] = local + np.repeat(snap.offsets, counts)
        if not state.delta.empty:
            out += state.delta.adjust(q)
        return out

    # -- updates ------------------------------------------------------------
    def insert(self, keys: np.ndarray) -> int:
        """Buffer inserted keys (duplicates add logical occurrences); merges
        once the delta reaches ``merge_threshold``. Returns the number of
        keys buffered."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        n = self._state.delta.insert(keys)
        self.stats.inserts += n
        self._after_update()
        return n

    def delete(self, keys: np.ndarray) -> int:
        """Tombstone key values: every logical occurrence of each key
        (snapshot and pending inserts) is removed. Returns the number of
        occurrences removed."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        n = self._state.delta.delete(keys)
        self.stats.deletes += n
        self._after_update()
        return n

    def _after_update(self) -> None:
        if 0 < self.merge_threshold <= self._state.delta.n_entries:
            self.merge()

    def merge(self) -> bool:
        """Fold the delta into a brand-new snapshot and swap it in (one
        reference assignment). Returns ``False`` for an empty delta or an
        empty logical key set, which stays buffered."""
        state = self._state
        if state.delta.empty:
            return False
        new_keys = state.delta.logical_keys()
        if new_keys.size == 0:
            return False
        self._state = self._new_state(new_keys)
        self.stats.merges += 1
        return True
