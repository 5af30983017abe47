"""DeltaBuffer — the mutable half of the snapshot + delta ownership model.

An updatable ``PlexService`` answers every lookup from two structures:

* an immutable ``core.index.Snapshot`` (frozen PLEX shards + key array +
  stacked device planes), and
* this buffer: the inserts and deletes accepted since the last merge.

The buffer's logical content is a sorted multiset of signed entries:

* ``+1`` for each live inserted key (duplicates allowed — inserting a key
  twice yields two logical occurrences), and
* ``-multiplicity`` for each *tombstoned* key, where the multiplicity is
  the key's occurrence count in the snapshot (captured when the tombstone
  is created; the snapshot is immutable, so it never goes stale).

Deletes are tombstones over key *values*: ``delete(k)`` removes every
snapshot occurrence of ``k`` and kills any pending insert of ``k``. A later
``insert(k)`` is live again (the tombstone keeps suppressing the snapshot
occurrences; the new insert adds one logical occurrence).

Merged-lookup algebra — the reason this exact representation exists: for
the logical key array ``L = sorted(snapshot - tombstoned + inserted)``,

    searchsorted(L, q, "left") = searchsorted(S, q, "left")
                                 + sum(weight of delta entries with key < q)

so one exclusive prefix sum over the sorted (key, weight) entries turns any
snapshot rank into a merged rank with a single bisect + gather. The device
view (``repro_torch.kernels.planes.DeltaPlanes``) carries exactly that:
padded sorted biased-key plane plus the int32 weight prefix, rebuilt lazily
after mutations and sized to a power-of-two capacity (pinned to the
service's merge threshold, grown geometrically past it), so the kernel's
fixed-trip bisect depth changes only a handful of times.

This module is the port's copy of ``repro.serving.delta``; only the device
view differs (torch tensors on an explicit device).

Thread-safety: single-writer, lock-free readers. Every mutation builds a
complete new ``_DeltaState`` (entry arrays *and* their sorted/prefix
derivatives) and publishes it with one reference assignment, so a reader
that captured a state mid-mutation always sees internally consistent
arrays; the device-plane cache is keyed by state identity for the same
reason.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# smallest device-view capacity; also the growth quantum's floor. Power of
# two so the merged pipeline's fixed-trip bisect depth is exact.
DELTA_CAP_MIN = 128


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1). The capacity quantum shared by
    the buffer's device view and the service's warm-compile sizing."""
    return 1 << max(int(n - 1).bit_length(), 0)


@dataclasses.dataclass(frozen=True)
class _DeltaState:
    """One immutable published buffer state: raw entry arrays plus the
    sorted merged entries and exclusive weight prefix derived from them.
    Readers capture the whole bundle through a single reference."""
    ins: np.ndarray          # sorted live inserts (dups ok)
    del_keys: np.ndarray     # sorted unique tombstoned keys
    del_counts: np.ndarray   # snapshot occurrences per tombstone
    keys: np.ndarray         # sorted merged entry keys
    weights: np.ndarray      # +1 per insert, -count per tombstone
    cum0: np.ndarray         # exclusive weight prefix, len(keys) + 1


def _build_state(ins: np.ndarray, del_keys: np.ndarray,
                 del_counts: np.ndarray) -> _DeltaState:
    keys = np.concatenate([ins, del_keys])
    weights = np.concatenate([np.ones(ins.size, dtype=np.int64),
                              -del_counts])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    weights = weights[order]
    cum0 = np.concatenate([[0], np.cumsum(weights)])
    return _DeltaState(ins=ins, del_keys=del_keys, del_counts=del_counts,
                       keys=keys, weights=weights, cum0=cum0)


_EMPTY_U64 = np.empty(0, dtype=np.uint64)
_EMPTY_I64 = np.empty(0, dtype=np.int64)


class DeltaBuffer:
    """Sorted insert/tombstone buffer bound to one immutable snapshot."""

    def __init__(self, snapshot_keys: np.ndarray, *,
                 capacity: int = DELTA_CAP_MIN):
        self._snap_keys = snapshot_keys
        self._cap = max(next_pow2(max(int(capacity), 1)), DELTA_CAP_MIN)
        self._state = _build_state(_EMPTY_U64, _EMPTY_U64, _EMPTY_I64)
        self._device = None      # (state, device, DeltaPlanes) cache

    # -- metadata -----------------------------------------------------------
    @property
    def n_entries(self) -> int:
        """Buffered delta entries (inserts + tombstones) — the merge-
        threshold metric, and what sizes the device view."""
        return int(self._state.keys.size)

    @property
    def n_inserts(self) -> int:
        return int(self._state.ins.size)

    @property
    def n_tombstones(self) -> int:
        return int(self._state.del_keys.size)

    @property
    def net_keys(self) -> int:
        """Logical key-count change vs the snapshot (inserts minus deleted
        snapshot occurrences)."""
        s = self._state
        return int(s.ins.size - s.del_counts.sum())

    @property
    def empty(self) -> bool:
        return self.n_entries == 0

    # -- mutation (single-writer) -------------------------------------------
    def insert(self, keys: np.ndarray) -> int:
        """Buffer inserted keys (duplicates add occurrences). Returns the
        number of keys buffered."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        s = self._state
        ins = np.sort(np.concatenate([s.ins, keys]))
        # one reference assignment publishes the complete new state
        self._state = _build_state(ins, s.del_keys, s.del_counts)
        return int(keys.size)

    def delete(self, keys: np.ndarray) -> int:
        """Tombstone key values: every snapshot occurrence of each key is
        logically removed and pending inserts of it are killed. Returns the
        number of logical occurrences removed (0 for keys absent from both
        the snapshot and the pending inserts)."""
        keys = np.unique(np.asarray(keys, dtype=np.uint64).ravel())
        if keys.size == 0:
            return 0
        s = self._state
        removed = 0
        ins = s.ins
        if ins.size:
            dead = np.isin(ins, keys)
            removed += int(dead.sum())
            if removed:
                ins = ins[~dead]
        # snapshot multiplicity per candidate tombstone (0 => pure no-op,
        # not stored; already-tombstoned keys are not double-counted)
        fresh = keys[~np.isin(keys, s.del_keys)]
        lo = np.searchsorted(self._snap_keys, fresh, side="left")
        hi = np.searchsorted(self._snap_keys, fresh, side="right")
        counts = (hi - lo).astype(np.int64)
        live = counts > 0
        del_keys, del_counts = s.del_keys, s.del_counts
        if np.any(live):
            del_keys = np.concatenate([del_keys, fresh[live]])
            del_counts = np.concatenate([del_counts, counts[live]])
            order = np.argsort(del_keys, kind="stable")
            del_keys = del_keys[order]
            del_counts = del_counts[order]
            removed += int(counts[live].sum())
        self._state = _build_state(ins, del_keys, del_counts)
        return removed

    # -- merged-lookup views -------------------------------------------------
    def entries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(sorted delta keys, signed weights, exclusive weight prefix).

        ``cum0`` has length ``n_entries + 1`` with a leading 0: the rank
        adjustment for ``q`` is ``cum0[searchsorted(keys, q, "left")]``."""
        s = self._state
        return s.keys, s.weights, s.cum0

    def adjust(self, q: np.ndarray) -> np.ndarray:
        """Host-side merged-rank adjustment (the per-shard path): add this
        to an exact snapshot rank to get the logical merged rank."""
        s = self._state
        if s.keys.size == 0:
            return np.zeros(np.asarray(q).shape, dtype=np.int64)
        return s.cum0[np.searchsorted(s.keys, np.asarray(q, np.uint64),
                                      "left")]

    def device_view(self, device):
        """``DeltaPlanes`` on ``device`` for the merged kernel launch,
        rebuilt lazily after mutations (the cache is keyed by published-
        state identity and device, so a lock-free reader can never pair
        planes with a different state's prefix). Capacity grows
        geometrically and never shrinks within an epoch."""
        s = self._state
        dev = self._device
        if dev is not None and dev[0] is s and dev[1] == device:
            return dev[2]
        from ..kernels.planes import build_delta_planes
        while s.keys.size > self._cap:
            self._cap *= 2
        planes = build_delta_planes(s.keys, s.weights, self._cap, device)
        self._device = (s, device, planes)
        return planes

    def pending_ops(self) -> list[tuple[str, np.ndarray]]:
        """Replayable ``("delete" | "insert", keys)`` records equivalent to
        this buffer's state. Deletes come first: replaying the tombstones
        against the same (immutable) snapshot recreates the exact
        multiplicities, and the inserts that follow are live again — the
        insert-after-delete semantics round-trip by construction."""
        s = self._state
        ops: list[tuple[str, np.ndarray]] = []
        if s.del_keys.size:
            ops.append(("delete", s.del_keys.copy()))
        if s.ins.size:
            ops.append(("insert", s.ins.copy()))
        return ops

    # -- merge support -------------------------------------------------------
    def capture(self) -> _DeltaState:
        """The currently-published immutable state bundle: the background
        merge's cut point. The merge worker captures it under the service
        lock, then materialises and builds from it off-lock while the
        writer keeps publishing newer states; pass it back to
        ``logical_keys(state=...)``."""
        return self._state

    def logical_keys(self, state: _DeltaState | None = None) -> np.ndarray:
        """Materialise the logical merged key array (snapshot occurrences
        minus tombstoned runs, plus live inserts) — the input to the next
        snapshot build. O(n) masking + one sort of the insert tail.
        ``state``: an earlier ``capture()``d bundle to materialise instead
        of the live one."""
        s = self._state if state is None else state
        snap = self._snap_keys
        if s.del_keys.size:
            edge = np.zeros(snap.size + 1, dtype=np.int64)
            lo = np.searchsorted(snap, s.del_keys, side="left")
            hi = np.searchsorted(snap, s.del_keys, side="right")
            np.add.at(edge, lo, 1)
            np.add.at(edge, hi, -1)
            snap = snap[np.cumsum(edge[:-1]) == 0]
        if s.ins.size == 0:
            return np.ascontiguousarray(snap)
        merged = np.concatenate([snap, s.ins])
        merged.sort(kind="stable")
        return merged
