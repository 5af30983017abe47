"""PlexService — serve (and update) PLEX lookups on one device.

The port of ``repro.serving.plex_service.PlexService``'s single-device
serving: a sharded snapshot built on the host, a delta buffer of inserts and
deletes, and one device launch per micro-batch.

* **Fused path.** When the shards unify (``kernels.planes``), each
  ``block``-sized micro-batch is one K1 launch, with the live delta folded
  into the same launch.
* **Per-shard path.** When they do not (mixed radix/CHT shards), queries are
  routed and grouped by shard on the host, uploaded once, and each shard's
  slice runs through a single-shard stacked impl, one launch per
  micro-batch; the host adds the global offsets and the delta adjustment.
* **Overlap.** Within one request's dispatch every launch but the first is
  a programmatic dependent launch on the one before it
  (``kernels.stacked_lookup``).
* **Hot-key cache.** ``cache_slots > 0`` gives the fused path a device
  cache of *snapshot* ranks inside K1 (the delta folds in after it, so
  entries survive updates and retire with their snapshot). Hits are
  counted per epoch (``stats.cache_hit_rate``); results are identical with
  the cache on or off.
* **Counted dispatch.** While ``obs.METRICS`` is armed (with
  ``counted_dispatch``), the fused path runs K1 with its counter plane
  (bypassing the cache) and the per-shard path counts the host routing;
  both fold at every sync point into the per-epoch ``live_hotness()`` and
  ``probe_trip_hist()`` (zero probe trips on the per-shard path) and into
  ``METRICS``.
* **Queue.** ``submit()`` packs the queries of many callers into shared
  micro-batches: full blocks launch at once, a remainder once its oldest
  query has waited ``max_delay_s`` (a timer thread flushes and drains it).
  Each launched batch holds a CUDA event, which ``drain()`` and
  ``LookupTicket.ready`` wait on or query. ``max_queue`` bounds the queue
  (``overflow="reject"`` raises ``QueueFullError``, ``"shed"`` returns a
  ticket carrying it). On the per-shard path ``submit`` answers at once.
* **Staging.** Queries are biased straight into a pinned host buffer and
  uploaded with ``non_blocking=True``. PyTorch's caching host allocator
  records an event behind each such copy and hands the buffer to a later
  upload only once that event has completed, so no submit overwrites
  queries still in flight.
* **Merges.** ``merge()`` rebuilds the snapshot from the logical key array
  and publishes the new (snapshot, delta, impl) state with one reference
  assignment; a new stats epoch starts, with an empty cache and zeroed
  hotness. ``merge_mode="sync"`` merges under the service lock;
  ``"background"`` hands threshold merges to a worker thread, which
  captures the delta under the lock, builds and uploads the new planes on
  a CUDA stream of its own with no lock held (updates land in an op
  journal meanwhile), synchronises that stream, and publishes with the
  journal's residual replayed. A failed merge leaves the live state as it
  was and arms a capped exponential backoff.

Consistency: ``insert``/``delete``/``merge`` drain the queue first, so a
queued lookup observes the state it was submitted against; ``lookup``
itself is lock-free and captures one consistent state per call.

There is no fallback chain: a kernel that fails to build or launch raises
out of ``lookup``, ``submit`` and ``drain`` (a failed queued batch parks the
error on its tickets first, so no ticket hangs). ``health()``, the backend
registry and ``throughput(backends=)``, persistence, fault injection,
tracing and the routed mesh are later slices of the port (``ROADMAP.md``
queue 1, items 4, 6, 7, 8 and 10).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from ..core.index import Snapshot
from ..device import resolve_device
from ..kernels.keys import to_biased
from ..kernels.planes import build_delta_planes, finalize_indices
from ..kernels.stacked_lookup import N_PROBE_BUCKETS, PROBE_MODES, \
    LaneResult, StackedTorchPlex, check_cache_slots
from ..obs.metrics import METRICS
from ..resilience.errors import MergeFailedError, QueueFullError
from .delta import DELTA_CAP_MIN, DeltaBuffer, next_pow2

__all__ = ["DEFAULT_MERGE_THRESHOLD", "LookupTicket", "PlexService",
           "ServiceStats"]

log = logging.getLogger("repro_torch.serving")

DEFAULT_MERGE_THRESHOLD = 4096
_BIAS = np.uint64(1 << 63)


@dataclasses.dataclass
class ServiceStats:
    queries: int = 0
    batches: int = 0              # micro-batches launched (one launch each)
    padded_lanes: int = 0         # always 0: the port launches valid lanes
    inflight_batches: int = 0     # launched, not yet synced
    drained_batches: int = 0      # synced back to the host
    # per-epoch counters (reset by new_epoch at every snapshot swap)
    epoch: int = 0
    cache_queries: int = 0        # lanes through the cache
    cache_hits: int = 0
    full_hit_batches: int = 0     # micro-batches whose every lane hit
    # update-path counters
    inserts: int = 0
    deletes: int = 0              # logical occurrences removed
    merges: int = 0
    merge_s: float = 0.0          # capture to publish, summed
    merge_failures: int = 0       # contained merge failures
    shed_queries: int = 0         # lanes refused by admission control
    # guards the per-epoch cache counters against a merge's new_epoch
    # racing a serving thread's sync-point adds (check-epoch-then-add must
    # be atomic, or an old epoch's batch lands in the new epoch's rate)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def note(self, n_queries: int, n_batches: int, n_padded: int) -> None:
        self.queries += n_queries
        self.batches += n_batches
        self.padded_lanes += n_padded

    def note_drained(self, n_batches: int) -> None:
        self.inflight_batches -= n_batches
        self.drained_batches += n_batches

    def note_cache_synced(self, hits: int, queries: int,
                          full_hit: bool, epoch: int) -> bool:
        """Fold one synced micro-batch's cache telemetry into the current
        epoch; dropped (atomically) when ``epoch`` is stale, i.e. the batch
        ran against a snapshot since swapped out. Returns whether it was
        applied."""
        with self._lock:
            if epoch != self.epoch:
                return False
            self.cache_queries += queries
            self.cache_hits += hits
            if full_hit:
                self.full_hit_batches += 1
            return True

    def new_epoch(self, epoch: int) -> None:
        """Start a fresh stats epoch at a snapshot swap: the cache counters
        restart, so ``cache_hit_rate`` describes the current snapshot."""
        with self._lock:
            self.epoch = epoch
            self.cache_queries = 0
            self.cache_hits = 0
            self.full_hit_batches = 0

    @property
    def cache_hit_rate(self) -> float:
        """Hit rate of the current epoch."""
        return self.cache_hits / self.cache_queries if self.cache_queries \
            else 0.0


class LookupTicket:
    """Handle for a ``PlexService.submit`` batch.

    Filled in place as its micro-batches drain; ``result()`` drains the
    service while lanes are outstanding. A ticket whose work failed (a
    kernel error, a shed queue) carries the error and raises it from
    ``result()``: a ticket never hangs and never returns partial
    results."""

    def __init__(self, svc: "PlexService", n: int):
        self._svc = svc
        self.n = n
        self._out = np.empty(n, dtype=np.int64)
        self._filled = 0
        self._queued = n          # lanes not launched yet
        self._events: list = []   # events of the batches holding its lanes
        self._error: BaseException | None = None

    @property
    def ready(self) -> bool:
        """Whether ``result()`` returns without waiting on the card: every
        lane is filled, or every lane is launched and the events of the
        batches holding them have completed."""
        if self._filled >= self.n:
            return True
        return self._queued == 0 and all(e is None or e.query()
                                         for e in self._events)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """The batch's indices; drains the service when lanes are still
        outstanding. ``timeout`` bounds that drain: on expiry a
        ``TimeoutError`` propagates and the ticket stays valid."""
        if self._filled < self.n:
            self._svc.drain(timeout=timeout)
        if self._error is not None:
            raise self._error
        return self._out


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
                 probe: str | None = None, cache_slots: int = 0,
                 max_delay_s: float = 0.002,
                 merge_threshold: int = DEFAULT_MERGE_THRESHOLD,
                 max_queue: int = 0, overflow: str = "reject",
                 merge_mode: str = "sync", merge_backoff_s: float = 0.05,
                 merge_backoff_cap_s: float = 5.0, device=None, **build_kw):
        self.device = resolve_device(device)
        if block % 128 != 0:
            raise ValueError("block must be a multiple of 128 lanes")
        if probe is not None and probe not in PROBE_MODES:
            raise ValueError(f"unknown probe mode {probe!r}")
        check_cache_slots(cache_slots)
        if overflow not in ("reject", "shed"):
            raise ValueError("overflow must be 'reject' or 'shed'")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        if merge_mode not in ("sync", "background"):
            raise ValueError("merge_mode must be 'sync' or 'background'")
        self.eps = int(eps)
        self.block = int(block)
        self.probe = probe
        self.cache_slots = int(cache_slots)
        self.max_delay_s = float(max_delay_s)
        self.merge_threshold = int(merge_threshold)
        self.max_queue = int(max_queue)
        self.overflow = overflow
        self.merge_mode = merge_mode
        self.merge_backoff_s = float(merge_backoff_s)
        self.merge_backoff_cap_s = float(merge_backoff_cap_s)
        self.stats = ServiceStats()
        self._n_shards_req = n_shards
        self._build_kw = build_kw
        # the merge threshold bounds the buffer, so the device view is
        # sized to it up front and keeps one capacity per snapshot
        self._delta_capacity = max(
            next_pow2(max(self.merge_threshold, 1)), DELTA_CAP_MIN)
        self._consec_merge_failures = 0
        self._merge_retry_at = 0.0
        # when the delta crossed the merge threshold without merging (None:
        # no backlog)
        self._backlog_since: float | None = None
        self._closed = False
        # background merges: _merge_mutex serialises merges with each other
        # (not with mutations: the lock order is _merge_mutex -> _lock, and
        # a background merge never holds _lock across the rebuild). The op
        # journal holds every mutation since the last capture point, the
        # residual the publish replays into the fresh delta.
        self._merge_mutex = threading.Lock()
        self._merge_wakeup = threading.Event()
        self._merge_worker: threading.Thread | None = None
        self._merge_stream = None
        self._op_seq = 0
        self._op_journal: collections.deque = collections.deque()
        # the queue: chunks are [ticket, queries, consumed, arrival];
        # outstanding holds launched, unsynced batches. Queue and update
        # state change only under the RLock (submit, drain, the deadline
        # timer, insert/delete/merge).
        self._q_chunks: collections.deque = collections.deque()
        self._q_len = 0
        self._outstanding: list[tuple] = []
        self._lock = threading.RLock()
        self._timer: threading.Timer | None = None
        snap = Snapshot.build(keys, self.eps, n_shards=n_shards,
                              device=self.device, **build_kw)
        self._state = self._new_state(snap)
        # live per-shard routed counts and probe-travel histogram of the
        # current epoch, folded from the counted dispatch at sync points;
        # reset at every publish (a merge may change the shard map)
        self._live = self._fresh_live(snap)

    def _new_state(self, snap: Snapshot) -> _ServiceState:
        """Put ``snap``'s planes on the device (the fused planes, or every
        shard's own when the shards do not unify), with a fresh delta and,
        with ``cache_slots``, an empty cache."""
        stacked = snap.stacked_impl(block=self.block, probe=self.probe,
                                    cache_slots=self.cache_slots)
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
    def epoch(self) -> int:
        return self._state.snapshot.epoch

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

    @property
    def n_keys(self) -> int:
        """Logical key count (snapshot plus pending delta)."""
        state = self._state
        return state.snapshot.n_keys + state.delta.net_keys

    def logical_keys(self) -> np.ndarray:
        """The logical key array lookups are answered against (snapshot
        minus tombstones plus pending inserts)."""
        state = self._state
        if state.delta.empty:
            return state.snapshot.keys
        return state.delta.logical_keys()

    def route(self, q: np.ndarray) -> np.ndarray:
        """Shard id per query (largest shard whose min key is <= q)."""
        return self._state.snapshot.route(q)

    def live_hotness(self) -> np.ndarray:
        """Per-shard routed-query counts of the current epoch, from the
        counted dispatch (zeros while ``METRICS`` was off this epoch)."""
        return self._live[1].copy()

    def probe_trip_hist(self) -> np.ndarray:
        """The current epoch's log2 histogram of probe travel (bucket 0: the
        window base was the answer; bucket ``b``: travel in
        ``[2**(b-1), 2**b)``), from the fused path's counted dispatch."""
        return self._live[2].copy()

    # -- lookups --------------------------------------------------------------
    def lookup(self, q: np.ndarray) -> np.ndarray:
        """Global first-occurrence index per query key in the *logical*
        (snapshot plus delta) key array."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        if not METRICS.enabled:
            return self._lookup(self._state, q)
        t0 = time.perf_counter()
        out = self._lookup(self._state, q)
        dur = time.perf_counter() - t0
        METRICS.histogram("serve.lookup_us").observe(dur * 1e6)
        METRICS.histogram("serve.lookup_ns_per_key").observe(
            dur * 1e9 / q.size)
        return out

    def _lookup(self, state: _ServiceState, q: np.ndarray) -> np.ndarray:
        if state.stacked is None:
            return self._lookup_per_shard(state, q)
        return self._stacked_lookup(state, q)

    def _upload(self, q: np.ndarray) -> torch.Tensor:
        """Biased device queries of the uint64 keys ``q``. On the card the
        queries are biased straight into a pinned buffer (the one host pass
        ``to_biased`` makes anyway) and copied with ``non_blocking=True``;
        PyTorch's caching host allocator hands the buffer out again only
        after the event it records behind that copy."""
        if self.device.type != "cuda":
            return torch.from_numpy(to_biased(q))
        buf = torch.empty(q.size, dtype=torch.int64, pin_memory=True)
        np.bitwise_xor(q, _BIAS, out=buf.numpy().view(np.uint64))
        return buf.to(self.device, non_blocking=True)

    def _delta_view(self, state: _ServiceState):
        """Device delta planes for the merged launch (``None`` while the
        epoch is read-only)."""
        return None if state.delta.empty \
            else state.delta.device_view(self.device)

    def _stacked_lookup(self, state: _ServiceState,
                        q: np.ndarray) -> np.ndarray:
        """Fused path: one upload, every micro-batch launched at once, one
        sync at the end."""
        st = state.stacked
        epoch = state.snapshot.epoch
        outs = st.dispatch(self._upload(q), self._delta_view(state))
        self.stats.inflight_batches += len(outs)
        self.stats.note(q.size, len(outs), 0)
        res = torch.cat([r.out for r in outs]).cpu().numpy()  # the sync
        self._note_synced(outs, epoch)
        self.stats.note_drained(len(outs))
        if METRICS.enabled:
            self._fold_impl_counters(st, epoch)
        return res.astype(np.int64)

    def _lookup_per_shard(self, state: _ServiceState,
                          q: np.ndarray) -> np.ndarray:
        """Per-shard path: queries grouped by shard on the host (one stable
        sort), one upload, each shard's slice through its single-shard impl
        (one launch per micro-batch, each after the first overlapping the
        one before), one copy back; each shard's clamp and global offset and
        the delta adjustment are folded on the host. The counted dispatch
        counts the host routing."""
        snap = state.snapshot
        sid = snap.route(q)
        counts = np.bincount(sid, minlength=snap.n_shards)
        if METRICS.enabled and METRICS.counted_dispatch:
            self._fold_hotness(counts, np.zeros(N_PROBE_BUCKETS, np.int64),
                               snap.epoch)
        # shard ids in the narrowest integer type: numpy's stable argsort
        # radix-sorts 8- and 16-bit keys
        order = np.argsort(sid.astype(np.min_scalar_type(snap.n_shards - 1)),
                           kind="stable")
        qd = self._upload(q[order])
        outs, start = [], 0
        for s, n in enumerate(counts):
            if n:
                st = snap.shard_impl(s, block=self.block, probe=self.probe)
                outs += st.dispatch(qd[start:start + n], chained=bool(outs),
                                    counted=False)
            start += n
        self.stats.inflight_batches += len(outs)
        self.stats.note(q.size, len(outs), 0)
        n_real = np.diff(np.append(snap.offsets, snap.n_keys))
        local = finalize_indices(torch.cat([r.out for r in outs]), q.size,
                                 np.repeat(n_real, counts))
        self.stats.note_drained(len(outs))
        out = np.empty(q.size, dtype=np.int64)
        out[order] = local + np.repeat(snap.offsets, counts)
        if not state.delta.empty:
            out += state.delta.adjust(q)
        return out

    def _note_synced(self, results: list[LaneResult], epoch: int) -> None:
        """Fold synced launches' cache telemetry into the stats (after the
        host has the results). ``epoch`` is the stats epoch they ran under:
        a launch that straddled a swap is dropped from the fresh epoch."""
        cached = [r for r in results if r.hits is not None]
        if not cached:
            return
        hits = torch.cat([r.hits for r in cached]).tolist()
        for r, h in zip(cached, hits):
            n = r.out.numel()
            self.stats.note_cache_synced(h, n, h == n, epoch)

    # -- live hotness ----------------------------------------------------------
    @staticmethod
    def _fresh_live(snap: Snapshot) -> tuple:
        """An epoch's empty live fold: (its snapshot's epoch, per-shard
        routed counts, probe-travel histogram), swapped as one reference."""
        return (snap.epoch, np.zeros(snap.n_shards, np.int64),
                np.zeros(N_PROBE_BUCKETS, np.int64))

    def _fold_hotness(self, shard_counts, probe_hist, epoch: int) -> None:
        """Fold one counter plane (per-shard routed counts and the probe
        histogram) of a dispatch that ran against the snapshot of ``epoch``
        into that epoch's live estimate and mirror it into ``METRICS``. A
        fold of an older epoch is dropped; one that races a publish adds
        into the fold it checked, which the publish discards."""
        live_epoch, hot, hist_live = self._live
        if live_epoch != epoch:
            return
        counts = np.asarray(shard_counts, np.int64)
        hist = np.asarray(probe_hist, np.int64)
        hot += counts
        hist_live += hist
        METRICS.counter("serve.routed_queries").inc(int(counts.sum()))
        METRICS.vector("serve.shard.routed", hot.size).add(counts)
        METRICS.vector("serve.probe.trips", N_PROBE_BUCKETS).add(hist)

    def _fold_impl_counters(self, st: StackedTorchPlex, epoch: int) -> None:
        """Read ``st``'s counter plane (if a counted dispatch ran) into the
        live fold of ``epoch``, the epoch of the snapshot ``st`` serves."""
        taken = st.take_counters()
        if taken is not None:
            self._fold_hotness(taken[0], taken[1], epoch)

    # -- updates ------------------------------------------------------------
    def insert(self, keys: np.ndarray) -> int:
        """Buffer inserted keys (duplicates add logical occurrences). Drains
        the queue first and merges once the delta reaches
        ``merge_threshold``. Returns the number of keys buffered."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        with self._lock:
            self.drain()
            state = self._state
            n = state.delta.insert(keys)
            self._journal_op("insert", keys)
            self.stats.inserts += n
            self._after_update(state)
            return n

    def delete(self, keys: np.ndarray) -> int:
        """Tombstone key values: every logical occurrence of each key
        (snapshot and pending inserts) is removed. Drains the queue first.
        Returns the number of occurrences removed."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        with self._lock:
            self.drain()
            state = self._state
            n = state.delta.delete(keys)
            self._journal_op("delete", keys)
            self.stats.deletes += n
            self._after_update(state)
            return n

    def _journal_op(self, opname: str, keys: np.ndarray) -> None:
        """Record one accepted mutation (lock held; background mode only):
        ops journaled after a merge's capture point are replayed into its
        fresh delta at publish."""
        if self.merge_mode != "background":
            return
        self._op_seq += 1
        self._op_journal.append((self._op_seq, opname, keys.copy()))

    def _after_update(self, state: _ServiceState) -> None:
        # no cache invalidation: entries hold delta-independent ranks
        if not 0 < self.merge_threshold <= state.delta.n_entries:
            return
        if self._backlog_since is None:
            self._backlog_since = time.monotonic()
        if self._consec_merge_failures and \
                time.monotonic() < self._merge_retry_at:
            return    # backing off: the delta keeps serving merged reads
        if self.merge_mode == "background":
            self._notify_merge_worker()     # never waits on a merge
            return
        try:
            self.merge()
        except MergeFailedError:
            pass      # contained: backoff armed, the live state untouched

    def merge(self) -> bool:
        """Fold the delta into a brand-new snapshot and swap it in (one
        reference assignment), starting a new stats epoch. Returns
        ``False`` for an empty delta or an empty logical key set, which
        stays buffered; raises ``MergeFailedError`` (the live state
        untouched) when the rebuild fails.

        ``merge_mode="sync"`` holds the service lock throughout;
        ``"background"`` merges in the calling thread under the merge
        mutex, holding the service lock only to capture and to publish."""
        if self.merge_mode == "background":
            with self._merge_mutex:
                return self._merge_once()
        with self._lock:
            self.drain()
            return self._merge_once()

    @contextlib.contextmanager
    def _on_device(self, stream=None):
        """This service's card as the current device (for threads of the
        service), and ``stream`` as the current stream when given."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.device(self.device):
            if stream is None:
                yield
            else:
                with torch.cuda.stream(stream):
                    yield

    def _merge_once(self) -> bool:
        """One capture -> rebuild -> publish cycle. The caller serialises
        merges (sync: the service lock; background: the merge mutex, so
        the rebuild runs with no service lock held)."""
        with self._lock:
            state = self._state
            if state.delta.empty:
                return False
            # the capture point: everything journaled after seq0 is the
            # residual, replayed into the fresh delta at publish
            dstate = state.delta.capture()
            seq0 = self._op_seq
            while self._op_journal and self._op_journal[0][0] <= seq0:
                self._op_journal.popleft()
        t0 = time.perf_counter()
        new_keys = state.delta.logical_keys(dstate)
        if new_keys.size == 0:
            return False      # a snapshot cannot be empty; keep buffering
        try:
            snap = Snapshot.build(
                new_keys, self.eps, n_shards=self._n_shards_req,
                device=self.device, epoch=state.snapshot.epoch + 1,
                **self._build_kw)
            # the new planes go up on a stream of the merge's own while the
            # old ones serve, are warmed there, and are published only once
            # that stream has finished: no lookup reads a half-uploaded
            # plane. Serving syncs before it drops a state, so the old
            # planes are never freed under a running launch.
            if self.device.type == "cuda" and self._merge_stream is None:
                self._merge_stream = torch.cuda.Stream(self.device)
            with self._on_device(self._merge_stream):
                new = self._new_state(snap)
                self._warm(new)
            if self._merge_stream is not None:
                self._merge_stream.synchronize()
        except Exception as e:
            raise self._arm_merge_backoff(e) from e
        with self._lock:
            self.drain()
            for _, name, op_keys in self._op_journal:
                getattr(new.delta, name)(op_keys)
            self._op_journal.clear()
            self._state = new
            self._consec_merge_failures = 0
            self._merge_retry_at = 0.0
            self._backlog_since = None
            self.stats.merges += 1
            self.stats.merge_s += time.perf_counter() - t0
            self.stats.new_epoch(snap.epoch)
            self._live = self._fresh_live(snap)
        if METRICS.enabled:
            METRICS.counter("merge.cycles").inc()
        return True

    def _arm_merge_backoff(self, e: BaseException) -> MergeFailedError:
        """Count one contained merge failure and arm the capped exponential
        retry backoff; returns the ``MergeFailedError`` to raise."""
        self.stats.merge_failures += 1
        self._consec_merge_failures += 1
        backoff = min(self.merge_backoff_cap_s,
                      self.merge_backoff_s *
                      2.0 ** (self._consec_merge_failures - 1))
        self._merge_retry_at = time.monotonic() + backoff
        log.warning("merge failed (attempt %d, retry in %.3fs): %r; live "
                    "state untouched", self._consec_merge_failures,
                    backoff, e)
        return MergeFailedError(
            f"merge failed ({self._consec_merge_failures} consecutive "
            f"attempt(s)): {e!r}; the live state is untouched and the "
            "delta keeps serving")

    # -- background merge worker --------------------------------------------
    def _notify_merge_worker(self) -> None:
        """Wake the merge worker (lock held), starting a fresh one when
        none is alive: a worker that died is replaced on the next update
        after its backoff."""
        if self._closed:
            return
        w = self._merge_worker
        if w is None or not w.is_alive():
            w = threading.Thread(target=self._merge_worker_main,
                                 name="plex-merge-worker", daemon=True)
            self._merge_worker = w
            w.start()
        self._merge_wakeup.set()

    def _merge_worker_main(self) -> None:
        """Wait for a wakeup, check that a merge is due (threshold still
        reached, backoff expired), run one cycle under the merge mutex.
        ``MergeFailedError`` is contained; any other exception ends this
        worker with the same backoff armed and the live state untouched."""
        with self._on_device():
            while True:
                self._merge_wakeup.wait()
                self._merge_wakeup.clear()
                if self._closed:
                    return
                try:
                    if self._consec_merge_failures and \
                            time.monotonic() < self._merge_retry_at:
                        continue
                    if not 0 < self.merge_threshold \
                            <= self._state.delta.n_entries:
                        continue
                    with self._merge_mutex:
                        try:
                            self._merge_once()
                        except MergeFailedError:
                            pass  # contained; backoff armed, retry later
                except Exception as e:
                    self._arm_merge_backoff(e)
                    log.warning("merge worker died: %r; a fresh worker "
                                "starts on the next update", e,
                                exc_info=True)
                    return

    def close(self) -> None:
        """Drain outstanding work and stop the merge worker (an in-flight
        merge finishes first). Idempotent; the service is a context
        manager."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cancel_timer()
            self.drain()
            worker = self._merge_worker
        # joined outside the lock: the worker's publish needs it
        if worker is not None and worker.is_alive():
            self._merge_wakeup.set()
            worker.join()

    def __enter__(self) -> "PlexService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- the queue --------------------------------------------------------------
    def submit(self, q: np.ndarray) -> LookupTicket:
        """Queue queries for micro-batch formation across callers.

        Full blocks launch at once (asynchronously); a remainder launches
        once the oldest queued query has waited ``max_delay_s``, by a timer
        thread if no further call comes. On the per-shard path the ticket
        is filled at once. With ``max_queue > 0`` a submit that would pass
        the bound is refused: ``overflow="reject"`` raises
        ``QueueFullError``, ``"shed"`` returns a ticket carrying it."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        ticket = LookupTicket(self, q.size)
        if q.size == 0:
            return ticket
        with self._lock:
            if self.max_queue and self._q_len + q.size > self.max_queue:
                err = QueueFullError(
                    f"submit: queue holds {self._q_len} of "
                    f"{self.max_queue} lanes; {q.size} more would exceed "
                    "the bound")
                self.stats.shed_queries += q.size
                if self.overflow == "reject":
                    raise err
                ticket._error = err
                ticket._filled, ticket._queued = q.size, 0
                return ticket
            # captured under the lock: mutations hold it too, so a queued
            # launch never pairs this snapshot with another epoch's delta
            st = self._state.stacked
            if st is None:
                ticket._out[:] = self.lookup(q)
                ticket._filled, ticket._queued = q.size, 0
                return ticket
            now = time.monotonic()
            self._q_chunks.append([ticket, q, 0, now])
            self._q_len += q.size
            self.stats.queries += q.size
            self._flush_full(st)
            if self._q_len:
                age = now - self._q_chunks[0][3]
                if age >= self.max_delay_s:
                    self._flush_partial(st)
                else:
                    self._arm_timer(self.max_delay_s - age)
        return ticket

    def _arm_timer(self, delay_s: float) -> None:
        """Schedule the deadline flush (one live timer at most; lock
        held)."""
        if self._timer is not None:
            return
        t = threading.Timer(max(delay_s, 0.0), self._deadline_flush)
        t.daemon = True
        self._timer = t
        t.start()

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _deadline_flush(self) -> None:
        """Timer thread: launch and drain the queued remainder once its
        deadline has passed (re-arm when woken early). A failure is parked
        on the tickets it concerns and logged here."""
        with self._on_device(), self._lock:
            self._timer = None
            if not self._q_len:
                return
            age = time.monotonic() - self._q_chunks[0][3]
            if age < self.max_delay_s:
                self._arm_timer(self.max_delay_s - age)
                return
            try:
                self._flush_partial(self._state.stacked)
                self._drain_outstanding()
            except Exception:
                log.exception("deadline flush failed; the error is parked "
                              "on its tickets")

    def _take_block(self, want: int) -> tuple[np.ndarray, list, int]:
        """Pop up to ``want`` queued queries into a fresh block (fresh: a
        launched block stays in flight across calls); returns (block,
        ticket pieces, lanes filled)."""
        buf = np.empty(want, dtype=np.uint64)
        pieces = []
        filled = 0
        while filled < want and self._q_chunks:
            entry = self._q_chunks[0]
            ticket, arr, consumed, arrival = entry
            take = min(want - filled, arr.size - consumed)
            buf[filled:filled + take] = arr[consumed:consumed + take]
            pieces.append((ticket, filled, consumed, take))
            ticket._queued -= take
            entry[2] += take
            filled += take
            if METRICS.enabled:
                METRICS.histogram("serve.queue_wait_us").observe(
                    max(time.monotonic() - arrival, 0.0) * 1e6)
            if entry[2] == arr.size:
                self._q_chunks.popleft()
        self._q_len -= filled
        return buf[:filled], pieces, filled

    @staticmethod
    def _fail_pieces(pieces: list, err: BaseException) -> None:
        """Park ``err`` on every ticket with lanes in a failed block, so
        none waits for them."""
        for ticket, _, _, cnt in pieces:
            ticket._error = err
            ticket._filled += cnt

    def _dispatch_queue_block(self, st: StackedTorchPlex, buf: np.ndarray,
                              pieces: list, filled: int) -> None:
        """Launch one queue block (one K1 launch) and record its event."""
        try:
            res = st.lookup_planes(self._upload(buf), n_valid=filled,
                                   delta=self._delta_view(self._state))
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
        except Exception as e:
            self._fail_pieces(pieces, e)
            raise
        for ticket, _, _, _ in pieces:
            ticket._events.append(ev)
        self._outstanding.append((res, pieces, self.stats.epoch, ev))
        self.stats.inflight_batches += 1
        self.stats.note(0, 1, 0)

    def _flush_full(self, st: StackedTorchPlex) -> None:
        while self._q_len >= self.block:
            self._dispatch_queue_block(st, *self._take_block(self.block))

    def _flush_partial(self, st: StackedTorchPlex) -> None:
        self._flush_full(st)
        if self._q_len:
            self._dispatch_queue_block(st, *self._take_block(self._q_len))

    def _drain_outstanding(self, deadline: float | None = None) -> None:
        """Wait for every launched queue block (its event), copy it back and
        fill its tickets (lock held). ``deadline`` bounds the waits: on
        expiry ``TimeoutError`` propagates with the remaining blocks left
        outstanding."""
        while self._outstanding:
            res, pieces, epoch, ev = self._outstanding[0]
            while ev is not None and not ev.query():
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"drain: deadline expired with "
                        f"{len(self._outstanding)} batch(es) in flight")
                if deadline is None:
                    ev.synchronize()
                else:
                    time.sleep(1e-4)
            self._outstanding.pop(0)
            try:
                arr = res.out.cpu().numpy()
                self._note_synced([res], epoch)
            except Exception as e:
                self._fail_pieces(pieces, e)
                self.stats.note_drained(1)
                raise
            for ticket, src, dst, cnt in pieces:
                ticket._out[dst:dst + cnt] = arr[src:src + cnt]
                ticket._filled += cnt
            self.stats.note_drained(1)
        if METRICS.enabled:
            state = self._state
            if state.stacked is not None:
                self._fold_impl_counters(state.stacked,
                                         state.snapshot.epoch)

    def drain(self, timeout: float | None = None) -> None:
        """Launch the queued remainder and sync every launched block,
        filling all pending tickets: the service's one blocking point.
        ``timeout`` bounds the whole call (the lock and the waits) and
        raises ``TimeoutError`` on expiry; unsynced blocks stay
        outstanding for the next drain."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        if timeout is None:
            self._lock.acquire()
        elif not self._lock.acquire(timeout=float(timeout)):
            raise TimeoutError(
                f"drain: service lock not acquired within {timeout}s")
        try:
            self._cancel_timer()
            if self._q_len:
                # queued chunks exist only while the state is fused: a
                # publish drains the queue before it swaps the state
                self._flush_partial(self._state.stacked)
            self._drain_outstanding(deadline)
        finally:
            self._lock.release()

    # -- warm-up ------------------------------------------------------------
    def _warm(self, state: _ServiceState) -> None:
        """Launch once each K1 variant serving ``state`` can take: on the
        fused path uncounted (cached, with ``cache_slots``) and counted,
        each delta-free and merged at the delta capacity (a zero-weight
        entry, which changes no result); on the per-shard path every
        shard's impl, delta-free (its delta folds on the host). Not served
        traffic: no stats, and the warm counts are discarded."""
        snap = state.snapshot
        q = torch.from_numpy(to_biased(snap.keys[:1])).to(self.device)
        if state.stacked is None:
            for s in range(snap.n_shards):
                snap.shard_impl(s, block=self.block, probe=self.probe) \
                    .lookup_planes(q, counted=False)
            return
        dummy = build_delta_planes(snap.keys[:1], np.zeros(1, np.int64),
                                   self._delta_capacity, self.device)
        for delta in (None, dummy):
            for counted in (False, True):
                state.stacked.lookup_planes(q, delta=delta, counted=counted)
        state.stacked.take_counters()

    def warmup(self) -> None:
        """Build the kernel library and launch each K1 variant this epoch's
        serving takes once, so the first served request pays no build and
        no first launch."""
        with self._on_device():
            self._warm(self._state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
