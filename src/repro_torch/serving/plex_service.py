"""PlexService — serve (and update) PLEX lookups on one device or over
placement slots.

The port of ``repro.serving.plex_service.PlexService``: a sharded snapshot
built on the host (or opened from disk), a delta buffer of inserts and
deletes, and one device launch per micro-batch.

* **Backends.** Names resolve through the registry (``kernels.backends``):
  ``cuda`` (the default: K1, one launch per micro-batch), ``torch`` (the
  same pipeline's plain PyTorch version on the same device) and ``numpy``
  (the host PLEX). ``lookup(q, backend=)`` picks one per call.
* **Fused path.** When the shards unify (``kernels.planes``), each
  ``block``-sized micro-batch is one launch, with the live delta folded
  into the same launch.
* **Per-shard path.** When they do not (mixed radix/CHT shards), queries are
  routed and grouped by shard on the host, uploaded once, and each shard's
  slice runs through a single-shard stacked impl, one launch per
  micro-batch; the host adds the global offsets and the delta adjustment.
* **Routed path (opt-in).** ``plan=`` places the snapshot over slots of
  ``devices=`` (every visible card by default; a list may repeat one card,
  and then each slot is a partition of its own on it): an int spans that
  many slots (a ``PlacementPlan`` pins the first assignment), shards are
  bin-packed onto slots from build statics (``distrib.placement``), each
  slot holds only its shard-contiguous slab and a stream of its own
  (``distrib.partition``), and lookups take the routed path
  (``distrib.routed_lookup``): host binning to slots, each slot's
  micro-batches through K1 on its stream with the delta folded in, one
  sync, host re-permutation. Unification is per slot, so a snapshot whose
  shards do not unify as a whole may still serve fused per slot. Every
  merge (and ``open``) re-plans the new snapshot, skew-aware once counted
  traffic has been seen (``live_hotness``). A slot whose slab fails to load
  is dropped: the service re-plans onto the others and reports a
  ``device.loss`` incident. A backend without a stacked path (``numpy``)
  gets no router; a plan whose slots do not unify serves without one.
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
  (bypassing the cache) and the per-shard and host paths count the host
  routing; both fold at every sync point into the per-epoch
  ``live_hotness()`` and ``probe_trip_hist()`` and into ``METRICS``.
* **Queue.** ``submit()`` packs the queries of many callers into shared
  micro-batches: full blocks launch at once, a remainder once its oldest
  query has waited ``max_delay_s`` (the service's one deadline thread
  flushes and drains it).
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
  journal's residual replayed.
* **Fault tolerance.** Every lookup runs through a fallback chain guarded
  by per-backend circuit breakers (``resilience.breakers``): a failed
  dispatch, or an open breaker, retries the identical merged lookup on the
  next backend — ``cuda`` -> ``torch`` -> ``numpy`` with
  ``fallback="auto"`` (a sequence names the chain, ``None`` disables it)
  — so degraded serving is slower, never wrong; only an exhausted chain
  raises, as ``BackendUnavailableError``. The chain is the default on the
  CPU only (``default_fallback``): on the card a K1 that fails to build or
  launch raises unless the caller asked for degraded serving, so no plain
  version or host PLEX answers in its place unasked. Every fallback logs a
  warning and counts in ``stats.fallback_lookups``. A failed queue block is
  answered through the same chain (``_fill_pieces_fallback``). A failed
  merge leaves the live state as it was and arms a capped exponential
  backoff. ``health()`` tells degraded from broken: generation, queue
  depth, WAL bytes, breaker states, the recent errors (the first error of
  the service's life, a kernel library that failed to build for one, is
  kept as the first of them).
* **Durability.** ``save(dir)`` persists the snapshot as a numbered
  generation of the reference's on-disk format (``persist``), seeds a
  fresh WAL with the live delta and publishes the manifest; from then on
  every ``insert``/``delete`` appends a WAL record before it mutates the
  delta, and a merge writes the next generation and commits it (one
  manifest rename) before its swap, then collects the old one.
  ``PlexService.open(dir)`` restarts from the last committed generation in
  load time: the planes are mapped and uploaded with the persisted statics
  (``load_s``), the WAL's valid prefix is replayed, and an unservable
  generation is quarantined in favour of the last known good one
  (``keep_generations``).

* **Parallel build.** ``build_workers=N`` fans the constructor's build and
  every merge's rebuild over a process pool (``core.parallel_build``;
  bit-identical to the serial build). The pool forks while this process has
  not initialised CUDA and spawns once it has (always on the card), so no
  worker opens a CUDA context.
* **Observability.** ``obs.TRACE`` spans time the host clock through the
  pipeline: ``serve.lookup`` around a request, ``serve.staging`` (the biased
  pinned upload), ``serve.dispatch`` (the enqueue of K1's launches) and
  ``serve.sync`` (the wait and the copy back); ``merge.capture``,
  ``merge.build`` and ``merge.publish``; ``persist.open``; and
  ``serve.new_state`` (the constructor's planes and upload, kept as
  ``upload_s`` whether traced or not). On the queue, each child inside its
  parent::

      serve.submit               req            submit()
        serve.lock               req            the wait for the service lock
        serve.take               reqs           queued queries into a block
          serve.queue_wait       req, lanes     each piece's time queued
        serve.staging            reqs           pinned buffer, bias, upload
        serve.dispatch           reqs, "queue"  K1's launch and its event
        serve.timer              req, op        the deadline armed (or
                                                cleared)
      serve.drain                req            drain(), result()
        serve.lock, serve.timer  req            the lock; the deadline
                                                cleared
        (serve.take, serve.staging, serve.dispatch: a remainder launched)
        serve.drain.wait         reqs           the host waiting on the card
        serve.copy_back          reqs           device to pageable host copy
        serve.cache_count        reqs           the cache's hit count read
        serve.fill               reqs           answers into the tickets, the
                                                block freed
      serve.deadline_flush       work           the deadline thread's pass;
                                                its lock (re-entered: the
                                                thread wakes holding it),
                                                launches and drains nest as
                                                above

  ``req`` is the ticket's id (``LookupTicket.id``, always assigned), ``reqs``
  the ids of the tickets with lanes in a block (built only while tracing),
  so a block the deadline thread answers is still tied to its requests.
  ``stats.timers_started``, ``deadline_threads``, ``deadline_flushes`` and
  ``deadline_idle`` count the deadlines armed, the deadline threads started
  and their passes, always. No span syncs the card or reads
  a device value, so a request's launches overlap as they do untraced.
  Incident bundles (``obs.incident``) are written for
  ``backend.unavailable``, ``merge.failure``, ``merge.worker_death``,
  ``generation.quarantine`` and ``queue.shed``, off the service lock where
  the caller does not hold it. ``attach_slo`` adds ``health()["slo"]``.

Consistency: ``insert``/``delete``/``merge`` drain the queue first, so a
queued lookup observes the state it was submitted against; ``lookup``
itself is lock-free and captures one consistent state per call.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import pathlib
import shutil
import threading
import time
import weakref
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.index import LearnedIndex, Snapshot
from ..device import resolve_device
from ..distrib.partition import partition_stacked, slot_device
from ..distrib.placement import (PlacementPlan, live_hotness, plan_matches,
                                 plan_placement)
from ..distrib.routed_lookup import RoutedStackedLookup
from ..kernels.backends import backend_names, get_backend
from ..kernels.keys import to_biased
from ..kernels.planes import build_delta_planes, finalize_indices
from ..kernels.stacked_lookup import N_PROBE_BUCKETS, PROBE_MODES, \
    LaneResult, StackedTorchPlex, check_cache_slots
from ..obs.incident import report as _report_incident
from ..obs.metrics import METRICS
from ..obs.trace import TRACE
from ..persist.format import load_snapshot, save_snapshot
from ..persist.manifest import CorruptManifestError, Manifest, gen_name, \
    read_manifest, wal_name, write_manifest
from ..persist.wal import OP_DELETE, OP_INSERT, WriteAheadLog
from ..resilience.breakers import CLOSED, DEFAULT_COOLDOWN_S, \
    DEFAULT_FAILURE_THRESHOLD, CircuitBreaker
from ..resilience.errors import BackendUnavailableError, MergeFailedError, \
    NoServableGenerationError, PartitionLoadError, QueueFullError
from ..resilience.faults import FAULTS, POINT_BACKEND_DISPATCH, \
    POINT_MERGE_BUILD, POINT_MERGE_WORKER, fire
from .delta import DELTA_CAP_MIN, DeltaBuffer, next_pow2

__all__ = ["DEFAULT_MERGE_THRESHOLD", "DEFAULT_WAL_ROTATE_BYTES",
           "LookupTicket", "PlexService", "QUARANTINE_DIR", "ServiceStats",
           "default_fallback"]

log = logging.getLogger("repro_torch.serving")

DEFAULT_MERGE_THRESHOLD = 4096
# WAL bytes that trigger an in-place compaction (checkpoint + pending ops),
# so recovery replay stays bounded by the delta, not the epoch's churn; 0
# disables rotation
DEFAULT_WAL_ROTATE_BYTES = 4 << 20
# the degradation order of fallback="auto": every backend computes the
# identical answer, so each step right is slower, never wrong
_CHAIN_ORDER = ("cuda", "torch", "numpy")
# fallback= left unset: default_fallback(device) decides
_UNSET = object()
# where open()'s last-known-good recovery moves unservable generations,
# outside every gen-*/wal-* glob
QUARANTINE_DIR = "quarantine"
# recent errors health() reports (the service's first error stays first)
_MAX_ERRORS = 16
_WAL_OPS = {"insert": OP_INSERT, "delete": OP_DELETE}
_BIAS = np.uint64(1 << 63)
# the deadline thread's longest wait: at least this often it looks whether
# its service was closed or collected
_DEADLINE_IDLE_S = 1.0


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
    wal_rotations: int = 0        # durable-WAL compactions
    # resilience counters
    fallback_lookups: int = 0     # lookups answered by a later backend
    backend_failures: int = 0     # dispatch/sync failures (incl. injected)
    merge_failures: int = 0       # contained merge/commit failures
    shed_queries: int = 0         # lanes refused by admission control
    # the queue's deadline: deadlines armed, deadline threads started (one
    # for the service's life unless it closes and serves again), and the
    # thread's passes that launched or drained work against those that
    # found none
    timers_started: int = 0
    deadline_threads: int = 0
    deadline_flushes: int = 0
    deadline_idle: int = 0
    # set-up: the constructor's planes and their upload (``_new_state``)
    upload_s: float = 0.0
    # per-backend breaker states (the full snapshots are in health())
    breakers: dict = dataclasses.field(default_factory=dict)
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
        self.id = next(svc._ticket_ids)   # the request id its spans carry
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
            self._svc._drain(timeout, req=self.id)
        if self._error is not None:
            raise self._error
        return self._out


@dataclasses.dataclass(frozen=True)
class _ServiceState:
    """One consistent (snapshot, delta, fused impl, router) state; published
    by a single reference assignment at a merge, so a reader never pairs a
    snapshot with another epoch's delta or with slots cut from another
    snapshot. ``stacked`` is the default backend's fused impl (``None``: the
    shards do not unify, the default backend is a host one, or the router
    serves); ``router`` the routed path (``None`` without a plan)."""
    snapshot: Snapshot
    delta: DeltaBuffer
    stacked: StackedTorchPlex | None
    router: RoutedStackedLookup | None = None


@dataclasses.dataclass
class _DurableState:
    """Durable-mode attachment: the directory, the committed generation and
    the open WAL handle of that generation; swapped as a unit when a merge
    commits the next generation (under the service lock)."""
    root: pathlib.Path
    generation: int
    wal: WriteAheadLog
    fsync: bool = True


def _coalesce_ops(records: Sequence[tuple[int, np.ndarray]]
                  ) -> Iterable[tuple[int, np.ndarray]]:
    """Merge runs of consecutive same-opcode WAL records into one op each
    (inserts within a run commute, and so do deletes; the run boundaries
    keep every insert/delete interleaving)."""
    run_op: int | None = None
    run: list[np.ndarray] = []
    for op, keys in records:
        if op != run_op and run:
            yield run_op, np.concatenate(run)
            run = []
        run_op = op
        run.append(keys)
    if run:
        yield run_op, np.concatenate(run)


def _gen_num(p: pathlib.Path) -> int | None:
    """Generation number of a ``gen-*`` / ``wal-*`` name, or ``None`` for a
    name that does not parse (never delete what cannot be identified)."""
    try:
        return int(p.stem.split("-", 1)[1])
    except (IndexError, ValueError):
        return None


def _gc_generations(root: pathlib.Path, keep: int, retain: int = 1) -> None:
    """Remove generation dirs and WAL segments superseded by ``keep``,
    retaining the newest ``retain`` generations (``keep`` and up to
    ``retain - 1`` predecessors: ``open``'s last-known-good candidates).
    Called only after the manifest has committed ``keep``. Best-effort: a
    leftover is collected at the next commit."""
    retain = max(int(retain), 1)
    gens = sorted((g for p in root.glob("gen-*")
                   if p.is_dir() and (g := _gen_num(p)) is not None
                   and g <= keep), reverse=True)
    live = set(gens[:retain]) | {keep}
    for p in root.glob("gen-*"):
        if p.is_dir() and _gen_num(p) not in live:
            log.info("gc(%s): removing generation %s", root, p.name)
            shutil.rmtree(p, ignore_errors=True)
    for p in root.glob("wal-*.log"):
        if _gen_num(p) not in live:
            log.info("gc(%s): removing WAL segment %s", root, p.name)
            try:
                p.unlink()
            except OSError:  # pragma: no cover
                pass


def _quarantine(root: pathlib.Path, *paths: pathlib.Path) -> None:
    """Move unservable on-disk state into ``root/quarantine/`` (forensic
    evidence, outside every ``gen-*``/``wal-*`` glob). Best-effort: a path
    that cannot be moved stays for the operator."""
    qdir = root / QUARANTINE_DIR
    for p in paths:
        if not p.exists():
            continue
        try:
            qdir.mkdir(exist_ok=True)
            target = qdir / p.name
            if target.is_dir():
                shutil.rmtree(target, ignore_errors=True)
            elif target.exists():
                target.unlink()
            p.rename(target)
            log.warning("quarantine(%s): moved %s aside", root, p.name)
        except OSError as e:  # pragma: no cover - fs-specific
            log.warning("quarantine(%s): could not move %s (%s)", root,
                        p.name, e)


def _reqs(pieces: list) -> tuple[int, ...]:
    """The request ids of a queue block's ticket pieces."""
    return tuple(piece[0].id for piece in pieces)


@contextlib.contextmanager
def _on_device(device: torch.device, stream=None):
    """``device`` as the current device when it is a card (for a service's
    own threads), and ``stream`` as the current stream when given."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        if stream is None:
            yield
        else:
            with torch.cuda.stream(stream):
                yield


def _deadline_loop(ref: weakref.ref, cond: threading.Condition,
                   device: torch.device) -> None:
    """A service's deadline thread. It waits on ``cond``, the condition over
    the service lock, until the armed deadline and runs the deadline pass
    once it has passed; a wake that finds the deadline cleared or later is
    no pass. With none armed it waits one ``max_delay_s`` if deadlines were
    armed since its last look (a stream of requests, whose arms then wake
    nobody), else ``_DEADLINE_IDLE_S``. It holds the service only through
    ``ref`` while it waits, and ends once the service is collected, or
    closed with no deadline armed."""
    seen = -1                       # stats.timers_started at the last look
    with _on_device(device), cond:
        try:
            while True:
                svc = ref()
                if svc is None or (svc._closed and svc._deadline is None):
                    return
                svc._sleep_until = None
                now = time.monotonic()
                due = svc._deadline
                if due is not None and due <= now:
                    svc._deadline_flush()
                    continue
                wait = _DEADLINE_IDLE_S
                if due is not None:
                    wait = min(wait, due - now)
                elif svc.stats.timers_started != seen:
                    # requests are flowing: a deadline armed from now on,
                    # max_delay_s ahead, falls due after this wait ends, so
                    # its arm need not notify
                    wait = min(wait, svc.max_delay_s)
                seen = svc.stats.timers_started
                svc._sleep_until = now + wait
                del svc
                cond.wait(wait)
        except Exception:
            # a dead thread is replaced at the next arm
            log.exception("deadline thread failed")
            svc = ref()
            if svc is not None:
                svc._deadline = svc._sleep_until = None


def default_fallback(device) -> str | None:
    """``fallback=``'s default on ``device``: ``"auto"`` on the CPU, where
    every backend runs a plain version anyway; ``None`` on the card, so a
    kernel that fails to build or launch raises rather than being answered
    by the plain pipeline or the host. Degraded serving on the card is the
    caller's explicit choice (``fallback="auto"`` or a sequence)."""
    return None if torch.device(device).type == "cuda" else "auto"


class PlexService:
    """Serve (and update) PLEX lookups across shards on one device."""

    def __init__(self, keys: np.ndarray | None, eps: int = 64, *,
                 n_shards: int | None = None, backend: str = "cuda",
                 block: int = 512, probe: str | None = None,
                 cache_slots: int = 0, max_delay_s: float = 0.002,
                 merge_threshold: int = DEFAULT_MERGE_THRESHOLD,
                 wal_rotate_bytes: int = DEFAULT_WAL_ROTATE_BYTES,
                 fallback: object = _UNSET,
                 breaker_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 breaker_cooldown_s: float = DEFAULT_COOLDOWN_S,
                 breaker_clock=time.monotonic,
                 max_queue: int = 0, overflow: str = "reject",
                 merge_mode: str = "sync", merge_backoff_s: float = 0.05,
                 merge_backoff_cap_s: float = 5.0,
                 keep_generations: int = 1, device=None,
                 build_workers: int | None = None,
                 devices: Sequence | None = None,
                 plan: PlacementPlan | int | None = None,
                 _snapshot: Snapshot | None = None, **build_kw):
        self.device = resolve_device(device)
        get_backend(backend)          # fail unknown names at construction
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
        if keep_generations < 1:
            raise ValueError("keep_generations must be >= 1")
        if build_workers is not None and int(build_workers) < 1:
            raise ValueError("build_workers must be >= 1 (None = serial)")
        # placement slots: every visible card for a card service, the
        # service's device on the CPU; a list may repeat a device
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        self._devices = [slot_device(d) for d in devices]
        if not self._devices:
            raise ValueError("devices must name at least one device")
        # int: span that many slots; PlacementPlan: pin the first
        # assignment (re-planned once it no longer matches the snapshot)
        if isinstance(plan, int):
            if not 1 <= plan <= len(self._devices):
                raise ValueError(f"plan={plan} devices requested but the "
                                 f"device list has {len(self._devices)}")
        elif plan is not None and not isinstance(plan, PlacementPlan):
            raise ValueError("plan must be an int device count or a "
                             "PlacementPlan")
        self._plan_req = plan
        if fallback is _UNSET:
            fallback = default_fallback(self.device)
        if isinstance(fallback, str) and fallback != "auto":
            raise ValueError("fallback must be 'auto', None, or a sequence "
                             "of backend names")
        if fallback is not None and fallback != "auto":
            fallback = tuple(fallback)
            for b in fallback:
                get_backend(b)        # fail unknown chain names up front
        self.eps = int(eps) if _snapshot is None else _snapshot.eps
        self.default_backend = backend
        self.block = int(block)
        self.probe = probe
        self.cache_slots = int(cache_slots)
        self.max_delay_s = float(max_delay_s)
        self.merge_threshold = int(merge_threshold)
        self.wal_rotate_bytes = int(wal_rotate_bytes)
        self.max_queue = int(max_queue)
        self.overflow = overflow
        self.merge_mode = merge_mode
        self.merge_backoff_s = float(merge_backoff_s)
        self.merge_backoff_cap_s = float(merge_backoff_cap_s)
        self.keep_generations = int(keep_generations)
        self.build_workers = None if build_workers is None \
            else int(build_workers)
        self.stats = ServiceStats()
        self._n_shards_req = n_shards
        self._build_kw = build_kw
        # resilience: the fallback chain per requested backend and one
        # breaker per backend
        self._fallback_req = fallback
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._breaker_clock = breaker_clock
        self._chains: dict[str, tuple[str, ...]] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._chain = self._chain_for(backend)
        for b in self._chain:
            self.stats.breakers[b] = self._breaker(b).state
        self._errors: list[str] = []
        self._errors_lock = threading.Lock()
        # the merge threshold bounds the buffer, so the device view is
        # sized to it up front and keeps one capacity per snapshot
        self._delta_capacity = max(
            next_pow2(max(self.merge_threshold, 1)), DELTA_CAP_MIN)
        self._consec_merge_failures = 0
        self._merge_retry_at = 0.0
        # when the delta crossed the merge threshold without merging (None:
        # no backlog)
        self._backlog_since: float | None = None
        self._last_backoff = 0.0
        self._closed = False
        # optional obs.slo.SLOWatchdog (attach_slo); health() grows a "slo"
        # section while one is attached
        self._slo = None
        # background merges: _merge_mutex serialises merges with each other
        # and with save() (not with mutations: the lock order is
        # _merge_mutex -> _lock, and a background merge never holds _lock
        # across the rebuild). The op journal holds every mutation since
        # the last capture point, the residual the publish replays into the
        # fresh delta.
        self._merge_mutex = threading.Lock()
        self._merge_wakeup = threading.Event()
        self._merge_worker: threading.Thread | None = None
        self._merge_stream = None
        self._op_seq = 0
        self._op_journal: collections.deque = collections.deque()
        # the queue: chunks are [ticket, queries, consumed, arrival];
        # outstanding holds launched, unsynced batches. Queue and update
        # state change only under the RLock (submit, drain, the deadline
        # thread, insert/delete/merge).
        self._q_chunks: collections.deque = collections.deque()
        self._q_len = 0
        self._outstanding: list[tuple] = []
        self._lock = threading.RLock()
        # the queue's deadline (monotonic seconds; None: none armed), served
        # by one deadline thread started at the first arm, which waits on
        # _cond until it; _sleep_until is when the thread's wait ends (None:
        # it is not waiting)
        self._cond = threading.Condition(self._lock)
        self._deadline: float | None = None
        self._sleep_until: float | None = None
        self._deadline_thread: threading.Thread | None = None
        self._ticket_ids = itertools.count(1)
        # durable-mode attachment (None: in memory only); load_s is the wall
        # time PlexService.open took (map, planes, WAL replay)
        self._dur: _DurableState | None = None
        self.load_s = 0.0
        if _snapshot is not None:
            snap = _snapshot
        else:
            keys = np.ascontiguousarray(keys, dtype=np.uint64)
            snap = Snapshot.build(keys, self.eps, n_shards=n_shards,
                                  device=self.device,
                                  workers=self.build_workers, **build_kw)
        t0 = time.perf_counter()
        self._state = self._new_state(snap)
        # enqueued, not synchronised: copies may still be in flight
        self.stats.upload_s = time.perf_counter() - t0
        if TRACE.enabled:
            TRACE.record("serve.new_state", self.stats.upload_s,
                         fused=self._state.stacked is not None)
        # live per-shard routed counts and probe-travel histogram of the
        # current epoch, folded from the counted dispatch at sync points;
        # reset at every publish (a merge may change the shard map)
        self._live = self._fresh_live(snap)

    def _new_state(self, snap: Snapshot) -> _ServiceState:
        """Put ``snap``'s planes on the device for the default backend (the
        router's slabs when a plan is requested and its slots unify, else
        the fused planes, or every shard's own when the shards do not
        unify), with a fresh delta and, with ``cache_slots``, an empty
        cache."""
        stacked = None
        router = self._make_router(snap)
        if router is None and get_backend(self.default_backend).stacked:
            stacked = self._stacked_for(snap, self.default_backend)
            if stacked is None:
                for s in range(snap.n_shards):
                    self._shard_impl(snap, s, self.default_backend)
        return _ServiceState(
            snap, DeltaBuffer(snap.keys, capacity=self._delta_capacity),
            stacked, router)

    def stacked_impl(self, state: _ServiceState | None = None,
                     backend: str | None = None):
        """The fused shard-major stacked path of ``state``'s snapshot (the
        current one by default) on ``backend`` (the service default when
        omitted), or ``None`` when the shards' static parameters could not
        be unified (per-shard fallback). Callers that already captured a
        state MUST pass it, so a concurrent swap can never pair one
        snapshot's planes with another epoch's delta."""
        state = state if state is not None else self._state
        return self._stacked_for(state.snapshot,
                                 backend or self.default_backend)

    def _stacked_for(self, snap: Snapshot, backend: str):
        """``snap``'s fused impl on ``backend`` at this service's
        configuration (cached by the snapshot; ``None``: the shards do not
        unify)."""
        return snap.stacked_impl(backend, block=self.block, probe=self.probe,
                                 cache_slots=self.cache_slots)

    def _shard_impl(self, snap: Snapshot, s: int, backend: str):
        return snap.shard_impl(s, backend, block=self.block, probe=self.probe)

    # -- metadata -----------------------------------------------------------
    @property
    def snapshot(self) -> Snapshot:
        return self._state.snapshot

    @property
    def keys(self) -> np.ndarray:
        """The *snapshot* key array (immutable). See ``logical_keys()`` for
        the merged view including pending updates."""
        return self._state.snapshot.keys

    @property
    def offsets(self) -> np.ndarray:
        return self._state.snapshot.offsets

    @property
    def shard_min(self) -> np.ndarray:
        return self._state.snapshot.shard_min

    @property
    def shards(self) -> Sequence[LearnedIndex]:
        """Each shard of the snapshot as a ``LearnedIndex`` (its ``keys``,
        ``eps``, ``size_bytes`` and ``stats``)."""
        return self._state.snapshot.indexes

    @property
    def size_bytes(self) -> int:
        return self._state.snapshot.size_bytes

    @property
    def name(self) -> str:
        return "PlexService"

    @property
    def n_shards(self) -> int:
        return self._state.snapshot.n_shards

    @property
    def epoch(self) -> int:
        return self._state.snapshot.epoch

    @property
    def build_s(self) -> float:
        """The snapshot's build time (a reopened one keeps its original)."""
        return self._state.snapshot.build_s

    @property
    def upload_s(self) -> float:
        """The wall time of the constructor's planes and their upload
        (``_new_state``, host planes and the enqueued copies; no sync)."""
        return self.stats.upload_s

    @property
    def fused(self) -> bool:
        """Whether lookups take the fused path (shards unified)."""
        return self._state.stacked is not None

    # -- routed path (distrib) ------------------------------------------------
    @property
    def devices(self) -> list[torch.device]:
        """The placement slots' devices (a device may repeat)."""
        return list(self._devices)

    @property
    def plan(self) -> PlacementPlan | None:
        """The active placement plan (``None`` without a plan, or when the
        plan's slots did not unify and the single-device paths serve)."""
        router = self._state.router
        return router.plan if router is not None else None

    def _make_router(self, snap: Snapshot) -> RoutedStackedLookup | None:
        """The routed path for ``snap`` from the placement request, or
        ``None`` when no plan was requested, the default backend has no
        stacked path, or a slot's shards do not unify. A pinned
        ``PlacementPlan`` is honoured only while it matches ``snap``'s exact
        shard table (``plan_matches``: a merge shifts offsets and minima
        even at an unchanged shard count, and stale boundaries would misbin
        queries); otherwise the plan is re-derived for the same slot count,
        scaled by this epoch's live hotness where counted traffic has been
        seen. A slot that fails to load (``PartitionLoadError``) is dropped:
        ``device.loss`` is reported and the snapshot is re-planned onto the
        others; with none left, no router serves."""
        req = self._plan_req
        if req is None or not get_backend(self.default_backend).stacked:
            return None
        devices = list(self._devices)
        # the live fold belongs to the epoch before a merge's snapshot: it
        # informs the plan only while the shard count still matches
        # (getattr: the constructor plans before the fold exists)
        live = getattr(self, "_live", None)
        hot = live_hotness(live[1] if live is not None else None,
                           snap.n_shards)
        if isinstance(req, PlacementPlan) and plan_matches(
                req, snap.offsets, snap.keys.size, snap.shard_min):
            plan = req
        else:
            n_dev = req.n_devices if isinstance(req, PlacementPlan) else req
            plan = plan_placement(snap, min(int(n_dev), len(devices)),
                                  hotness=hot)
        while True:
            try:
                parts = partition_stacked(
                    snap, plan, devices, block=self.block, probe=self.probe,
                    cache_slots=self.cache_slots,
                    backend=self.default_backend)
                break
            except PartitionLoadError as e:
                self._note_error(e)
                _report_incident("device.loss", str(e),
                                 device_index=int(e.device_index),
                                 survivors=len(devices) - 1)
                if len(devices) <= 1:
                    log.warning("router: %s; no surviving device to "
                                "re-plan onto, serving without a router", e)
                    return None
                dropped = devices.pop(e.device_index)
                log.warning("router: %s; re-planning onto %d surviving "
                            "device(s) (dropped %s)", e, len(devices),
                            dropped)
                plan = plan_placement(snap, min(plan.n_devices, len(devices)),
                                      hotness=hot)
        if parts is None:
            return None
        return RoutedStackedLookup(plan, parts, self.block)

    def _routed_lookup(self, state: _ServiceState, q: np.ndarray
                       ) -> np.ndarray:
        """Whole-batch routed (merged) lookup: host binning to slots, every
        slot's micro-batches enqueued on its stream, one sync, host
        re-permutation; the stats and the counted fold as on the fused
        path, each slot's counter plane folded at its first shard."""
        router = state.router
        epoch = state.snapshot.epoch
        with TRACE.span("serve.dispatch", path="routed", n=q.size):
            batch = router.dispatch(q, self._delta_view(state))
        self.stats.inflight_batches += batch.n_batches
        self.stats.note(q.size, batch.n_batches, batch.padded_lanes)
        with TRACE.span("serve.sync", path="routed", n=q.size):
            out = batch.assemble(q.size)   # the one sync point
        self._note_synced(list(batch.lane_results()), epoch)
        self.stats.note_drained(batch.n_batches)
        if METRICS.enabled:
            for d in router.plan.active:
                part = router.parts[d]
                self._fold_impl_counters(part.impl, epoch,
                                         base=part.shard_lo)
        return out

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
    def lookup(self, q: np.ndarray, backend: str | None = None) -> np.ndarray:
        """Global first-occurrence index per query key in the *logical*
        (snapshot plus delta) key array.

        Served through the fallback chain: the requested backend (the
        service's by default) first, then — on a dispatch failure or an
        open breaker — each configured fallback, all computing the
        identical answer. A lookup fails only when the whole chain is
        exhausted, as ``BackendUnavailableError``."""
        backend = backend or self.default_backend
        get_backend(backend)  # unknown names raise here, not as chain noise
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        if not (METRICS.enabled or TRACE.enabled):
            return self._lookup_chain(q, backend)
        t0 = time.perf_counter()
        with TRACE.span("serve.lookup", backend=backend, n=q.size):
            out = self._lookup_chain(q, backend)
        if METRICS.enabled:
            dur = time.perf_counter() - t0
            METRICS.histogram("serve.lookup_us").observe(dur * 1e6)
            METRICS.histogram("serve.lookup_ns_per_key").observe(
                dur * 1e9 / q.size)
        return out

    def _lookup_chain(self, q: np.ndarray, backend: str) -> np.ndarray:
        """The fallback-chain walk behind ``lookup`` over one captured
        state."""
        state = self._state
        chain = self._chain_for(backend)
        last_err: BaseException | None = None
        for b in chain:
            br = self._breaker(b)
            if not br.allow():
                continue          # open breaker: skip the known-bad backend
            try:
                out = self._lookup(state, q, b)
            except Exception as e:
                self.stats.backend_failures += 1
                self._note_error(e)
                self._record_breaker(br, False, e)
                last_err = e
                log.warning("lookup: backend %r failed (%r)%s", b, e,
                            "; falling back" if b != chain[-1] else "")
                continue
            self._record_breaker(br, True)
            if b != backend:
                self.stats.fallback_lookups += 1
                log.warning("lookup: served by %r in place of %r", b,
                            backend)
            return out
        err = BackendUnavailableError(chain, last_err)
        _report_incident("backend.unavailable", str(err),
                         health=self.health, chain=list(chain),
                         last_error=repr(last_err)
                         if last_err is not None else None)
        raise err from last_err

    def _lookup(self, state: _ServiceState, q: np.ndarray,
                backend: str | None = None) -> np.ndarray:
        """One backend's (the default one's) merged lookup over a captured
        state: fused, per-shard, or on the host; identical results on every
        path (the chain relies on that)."""
        backend = backend or self.default_backend
        snap = state.snapshot
        if get_backend(backend).stacked:
            # the slots' impls are the default backend's; another stacked
            # backend serves on the service's device
            if state.router is not None and backend == self.default_backend:
                return self._routed_lookup(state, q)
            st = (state.stacked if backend == self.default_backend
                  else self._stacked_for(snap, backend))
            if st is not None:
                return self._stacked_lookup(state, q, st)
            return self._lookup_per_shard(state, q, backend)
        # a host backend has no built impl to instrument: its dispatch
        # point fires here
        fire(POINT_BACKEND_DISPATCH, backend=backend)
        return self._lookup_host(state, q)

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

    def _stacked_lookup(self, state: _ServiceState, q: np.ndarray,
                        st: StackedTorchPlex | None = None) -> np.ndarray:
        """Fused path on ``st`` (default: the state's own fused impl): one
        upload, every micro-batch launched at once, one sync at the end."""
        st = state.stacked if st is None else st
        epoch = state.snapshot.epoch
        delta = self._delta_view(state)
        with TRACE.span("serve.staging", n=q.size):
            qd = self._upload(q)
        with TRACE.span("serve.dispatch", path="stacked", n=q.size):
            outs = st.dispatch(qd, delta)
        self.stats.inflight_batches += len(outs)
        self.stats.note(q.size, len(outs), 0)
        with TRACE.span("serve.sync", path="stacked", n=q.size):
            res = torch.cat([r.out for r in outs]).cpu().numpy()
        self._note_synced(outs, epoch)
        self.stats.note_drained(len(outs))
        if METRICS.enabled:
            self._fold_impl_counters(st, epoch)
        return res.astype(np.int64)

    def _lookup_per_shard(self, state: _ServiceState, q: np.ndarray,
                          backend: str) -> np.ndarray:
        """Per-shard path: queries grouped by shard on the host (one stable
        sort), one upload, each shard's slice through its single-shard impl
        (one launch per micro-batch, each after the first overlapping the
        one before), one copy back; each shard's clamp and global offset and
        the delta adjustment are folded on the host. The counted dispatch
        counts the host routing."""
        snap = state.snapshot
        with TRACE.span("serve.staging", n=q.size):
            sid = snap.route(q)
            counts = np.bincount(sid, minlength=snap.n_shards)
            if METRICS.enabled and METRICS.counted_dispatch:
                self._fold_hotness(counts,
                                   np.zeros(N_PROBE_BUCKETS, np.int64),
                                   snap.epoch)
            # shard ids in the narrowest integer type: numpy's stable
            # argsort radix-sorts 8- and 16-bit keys
            order = np.argsort(
                sid.astype(np.min_scalar_type(snap.n_shards - 1)),
                kind="stable")
            qd = self._upload(q[order])
        with TRACE.span("serve.dispatch", path="per-shard", n=q.size):
            outs, start = [], 0
            for s, n in enumerate(counts):
                if n:
                    st = self._shard_impl(snap, s, backend)
                    outs += st.dispatch(qd[start:start + n],
                                        chained=bool(outs), counted=False)
                start += n
        self.stats.inflight_batches += len(outs)
        self.stats.note(q.size, len(outs), 0)
        n_real = np.diff(np.append(snap.offsets, snap.n_keys))
        with TRACE.span("serve.sync", path="per-shard", n=q.size):
            local = finalize_indices(torch.cat([r.out for r in outs]),
                                     q.size, np.repeat(n_real, counts))
        self.stats.note_drained(len(outs))
        out = np.empty(q.size, dtype=np.int64)
        out[order] = local + np.repeat(snap.offsets, counts)
        if not state.delta.empty:
            out += state.delta.adjust(q)
        return out

    def _lookup_host(self, state: _ServiceState, q: np.ndarray) -> np.ndarray:
        """Host path: each shard's ``PLEX.lookup`` over its routed queries,
        the global offset and the delta adjustment folded in on the host
        (no launch)."""
        snap = state.snapshot
        sid = snap.route(q)
        if METRICS.enabled and METRICS.counted_dispatch:
            self._fold_hotness(np.bincount(sid, minlength=snap.n_shards),
                               np.zeros(N_PROBE_BUCKETS, np.int64),
                               snap.epoch)
        out = np.empty(q.size, dtype=np.int64)
        for s in np.unique(sid):
            mask = sid == s
            out[mask] = snap.shards[s].lookup(q[mask]) + snap.offsets[s]
        self.stats.note(q.size, 0, 0)
        if not state.delta.empty:
            out += state.delta.adjust(q)
        return out

    # -- resilience ---------------------------------------------------------
    def _chain_for(self, backend: str) -> tuple[str, ...]:
        """The fallback chain starting at ``backend``: the requested
        backend, then each configured fallback that is registered.
        ``"auto"`` degrades along cuda -> torch -> numpy from the requested
        backend's position (a custom backend falls back to torch, then
        numpy); a sequence is honoured in order; ``None`` disables
        fallback."""
        chain = self._chains.get(backend)
        if chain is not None:
            return chain
        req = self._fallback_req
        if req is None:
            tail: tuple[str, ...] = ()
        elif req == "auto":
            start = _CHAIN_ORDER.index(backend) + 1 \
                if backend in _CHAIN_ORDER else 1
            tail = _CHAIN_ORDER[start:]
        else:
            tail = req
        out = [backend]
        for b in tail:
            if b in out:
                continue
            try:
                get_backend(b)
            except ValueError:
                continue
            out.append(b)
        chain = tuple(out)
        self._chains[backend] = chain
        return chain

    def _breaker(self, backend: str) -> CircuitBreaker:
        br = self._breakers.get(backend)
        if br is None:
            # setdefault keeps exactly one breaker under lock-free races
            br = self._breakers.setdefault(backend, CircuitBreaker(
                backend, failure_threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s,
                clock=self._breaker_clock))
        return br

    def _record_breaker(self, br: CircuitBreaker, ok: bool,
                        error: BaseException | None = None) -> None:
        if ok:
            br.record_success()
        else:
            br.record_failure(error)
        self.stats.breakers[br.name] = br.state

    def _note_error(self, e: BaseException) -> None:
        """Bounded error journal read by ``health()``. The first error of
        the service's life stays first (a kernel library that failed to
        build is the error to read first), the rest roll."""
        with self._errors_lock:
            if len(self._errors) >= _MAX_ERRORS:
                del self._errors[1]
            self._errors.append(f"{type(e).__name__}: {e}")

    def health(self) -> dict:
        """One JSON-friendly operational snapshot: what an operator (or a
        chaos run) needs to tell *degraded* from *broken* — generation,
        queue depth, the deadlines armed and the deadline thread's starts
        and passes, WAL size, breaker states, recent errors. Lock-free;
        safe to poll while serving."""
        state = self._state
        dur = self._dur
        wal_bytes = 0
        if dur is not None and not dur.wal.closed:
            wal_bytes = dur.wal.size_bytes
        breakers = {n: b.snapshot()
                    for n, b in sorted(self._breakers.items())}
        retry_in = max(0.0, self._merge_retry_at - time.monotonic()) \
            if self._consec_merge_failures else 0.0
        backlog = 0.0 if self._backlog_since is None \
            else time.monotonic() - self._backlog_since
        with self._errors_lock:
            errors = list(self._errors)
        worker = self._merge_worker
        out = {
            "generation": self.generation,
            "epoch": int(state.snapshot.epoch),
            "n_keys": int(state.snapshot.n_keys + state.delta.net_keys),
            "n_pending": int(state.delta.n_entries),
            "routed_devices": state.router.plan.n_devices
            if state.router is not None else 0,
            "fallback_chain": list(self._chain),
            "breakers": breakers,
            "degraded": any(b["state"] != CLOSED for b in breakers.values())
            or self._consec_merge_failures > 0,
            "queue_depth": int(self._q_len),
            "queue_limit": int(self.max_queue),
            "inflight_batches": int(self.stats.inflight_batches),
            "timers_started": int(self.stats.timers_started),
            "deadline_threads": int(self.stats.deadline_threads),
            "deadline_flushes": int(self.stats.deadline_flushes),
            "deadline_idle": int(self.stats.deadline_idle),
            "shed_queries": int(self.stats.shed_queries),
            "backend_failures": int(self.stats.backend_failures),
            "fallback_lookups": int(self.stats.fallback_lookups),
            "merge_failures": int(self.stats.merge_failures),
            "merge_retry_in_s": round(retry_in, 3),
            "merge_backlog_s": round(backlog, 3),
            "merge_mode": self.merge_mode,
            "merge_worker_alive": worker is not None and worker.is_alive(),
            "journal_ops": len(self._op_journal),
            "wal_bytes": int(wal_bytes),
            "last_errors": errors,
            "armed_faults": FAULTS.active(),
            "closed": self._closed,
            "metrics": {
                "enabled": bool(METRICS.enabled),
                "shard_hotness": [int(x) for x in self._live[1]],
                "probe_trips": [int(x) for x in self._live[2]],
                "cache_hits": int(self.stats.cache_hits),
                "cache_queries": int(self.stats.cache_queries),
                "full_hit_batches": int(self.stats.full_hit_batches),
                "registry": METRICS.snapshot(),
            },
        }
        slo = self._slo
        if slo is not None:
            # present only while a watchdog is attached
            out["slo"] = slo.status()
        return out

    def attach_slo(self, watchdog):
        """Attach an ``obs.slo.SLOWatchdog`` (or ``None`` to detach): while
        attached, ``health()`` carries a ``"slo"`` section with each
        objective's state and burn rates. The service never drives the
        watchdog itself: a flight-recorder probe (``obs.slo.watch_service``)
        or a caller's loop feeds it ``observe(health())``. Returns the
        watchdog."""
        self._slo = watchdog
        return watchdog

    def _note_synced(self, results: list[LaneResult], epoch: int) -> None:
        """Fold synced launches' cache telemetry into the stats (after the
        host has the results). ``epoch`` is the stats epoch they ran under:
        a launch that straddled a swap is dropped from the fresh epoch."""
        cached = [r for r in results if r.hits is not None]
        if not cached:
            return
        hits = (cached[0].hits.tolist() if len(cached) == 1
                else torch.cat([r.hits for r in cached]).tolist())
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

    def _fold_hotness(self, shard_counts, probe_hist, epoch: int,
                      base: int = 0) -> None:
        """Fold one counter plane (per-shard routed counts of the shards
        from ``base`` on, and the probe histogram) of a dispatch that ran
        against the snapshot of ``epoch`` into that epoch's live estimate
        and mirror it into ``METRICS``. A fold of an older epoch is
        dropped; one that races a publish adds into the fold it checked,
        which the publish discards."""
        live_epoch, hot, hist_live = self._live
        if live_epoch != epoch:
            return
        counts = np.zeros(hot.size, np.int64)
        part = np.asarray(shard_counts, np.int64)
        counts[base:base + part.size] = part
        hist = np.asarray(probe_hist, np.int64)
        hot += counts
        hist_live += hist
        METRICS.counter("serve.routed_queries").inc(int(counts.sum()))
        METRICS.vector("serve.shard.routed", hot.size).add(counts)
        METRICS.vector("serve.probe.trips", N_PROBE_BUCKETS).add(hist)

    def _fold_impl_counters(self, st: StackedTorchPlex, epoch: int,
                            base: int = 0) -> None:
        """Read ``st``'s counter plane (if a counted dispatch ran) into the
        live fold of ``epoch``, the epoch of the snapshot ``st`` serves;
        ``st``'s first shard is the snapshot's shard ``base``."""
        taken = st.take_counters()
        if taken is not None:
            self._fold_hotness(taken[0], taken[1], epoch, base)

    # -- updates ------------------------------------------------------------
    def insert(self, keys: np.ndarray) -> int:
        """Buffer inserted keys (duplicates add logical occurrences). Drains
        the queue first; on a durable service the WAL record is appended
        before the delta changes. Merges once the delta reaches
        ``merge_threshold``. Returns the number of keys buffered."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        with self._lock:
            self.drain()
            state = self._state
            if self._dur is not None:
                # WAL before mutation: if the append raises, the delta is
                # untouched and durable >= served still holds
                self._dur.wal.append(OP_INSERT, keys)
            n = state.delta.insert(keys)
            self._journal_op("insert", keys)
            self.stats.inserts += n
            self._maybe_rotate_wal(state)
            self._after_update(state)
            return n

    def delete(self, keys: np.ndarray) -> int:
        """Tombstone key values: every logical occurrence of each key
        (snapshot and pending inserts) is removed. Drains the queue first
        and appends the WAL record first, as ``insert``. Returns the number
        of occurrences removed."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        if keys.size == 0:
            return 0
        with self._lock:
            self.drain()
            state = self._state
            if self._dur is not None:
                self._dur.wal.append(OP_DELETE, keys)
            n = state.delta.delete(keys)
            self._journal_op("delete", keys)
            self.stats.deletes += n
            self._maybe_rotate_wal(state)
            self._after_update(state)
            return n

    def _maybe_rotate_wal(self, state: _ServiceState) -> None:
        """Compact the durable WAL once it exceeds ``wal_rotate_bytes``
        (lock held, after the delta mutation, so the seed ops include the
        record just logged). Skipped when the compacted seed would not
        shrink the segment to at most half its size, so a delta near the
        threshold is not rewritten in full on every mutation."""
        dur = self._dur
        if dur is None or not 0 < self.wal_rotate_bytes <= dur.wal.size_bytes:
            return
        delta = state.delta
        seed_est = 9 * 3 + 8 * (delta.n_inserts + delta.n_tombstones)
        if seed_est * 2 > dur.wal.size_bytes:
            return
        ops = [(_WAL_OPS[name], op_keys)
               for name, op_keys in delta.pending_ops()]
        dur.wal = dur.wal.rotate(ops)
        self.stats.wal_rotations += 1

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

    def _merge_once(self) -> bool:
        """One capture -> rebuild -> publish cycle. The caller serialises
        merges (sync: the service lock; background: the merge mutex, so
        the rebuild runs with no service lock held)."""
        with TRACE.span("merge.capture"), self._lock:
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
        dur = self._dur
        new_gen = dur.generation + 1 if dur is not None else -1
        try:
            fire(POINT_MERGE_BUILD)
            snap = Snapshot.build(
                new_keys, self.eps, n_shards=self._n_shards_req,
                device=self.device, epoch=state.snapshot.epoch + 1,
                workers=self.build_workers, **self._build_kw)
            # the new planes go up on a stream of the merge's own while the
            # old ones serve, are warmed there, and are published only once
            # that stream has finished: no lookup reads a half-uploaded
            # plane. Serving syncs before it drops a state, so the old
            # planes are never freed under a running launch.
            if self.device.type == "cuda" and self._merge_stream is None:
                self._merge_stream = torch.cuda.Stream(self.device)
            with _on_device(self.device, self._merge_stream):
                new = self._new_state(snap)
                self._warm(new)
            if self._merge_stream is not None:
                self._merge_stream.synchronize()
            # durable phase 1: the snapshot write, still off the service
            # lock. Nothing is live until the manifest rename of phase 2,
            # so a crash here leaves a dead generation dir at worst.
            if dur is not None:
                try:
                    save_snapshot(dur.root / gen_name(new_gen), snap,
                                  fsync=dur.fsync)
                except Exception:
                    shutil.rmtree(dur.root / gen_name(new_gen),
                                  ignore_errors=True)
                    raise
        except Exception as e:
            err = self._arm_merge_backoff(e)
            self._report_merge_failure("merge.failure", e)
            raise err from e
        if TRACE.enabled:
            # build + warm + phase-1 write, measured from the capture point
            TRACE.record("merge.build", time.perf_counter() - t0,
                         n_keys=new_keys.size, epoch=snap.epoch)
        # the publish: drain the queue, durable phase 2 (a fresh WAL seeded
        # with the residual and one manifest rename), then the swap. A
        # failed commit is reported once the lock is released.
        try:
            self._publish(snap, new, dur, new_gen, t0)
        except MergeFailedError as err:
            self._report_merge_failure("merge.failure", err.__cause__)
            raise
        if METRICS.enabled:
            METRICS.counter("merge.cycles").inc()
        return True

    def _publish(self, snap: Snapshot, new: _ServiceState,
                 dur: _DurableState | None, new_gen: int, t0: float) -> None:
        """A merge's publish under the service lock: drain, the durable
        commit (a failure arms the backoff and raises ``MergeFailedError``
        with the live state untouched), the residual replay and the swap."""
        with TRACE.span("merge.publish", epoch=snap.epoch), self._lock:
            self.drain()
            residual = list(self._op_journal)
            new_dur = None
            if dur is not None:
                try:
                    new_dur = self._commit_generation(
                        dur.root, new_gen, snap,
                        [(name, op_keys) for _, name, op_keys in residual],
                        dur.fsync, snapshot_saved=True)
                except Exception as e:
                    raise self._arm_merge_backoff(e) from e
            for _, name, op_keys in residual:
                getattr(new.delta, name)(op_keys)
            self._op_journal.clear()
            self._state = new
            if new_dur is not None:
                self._swap_durable(new_dur)
            self._consec_merge_failures = 0
            self._merge_retry_at = 0.0
            self._backlog_since = None
            self.stats.merges += 1
            self.stats.merge_s += time.perf_counter() - t0
            self.stats.new_epoch(snap.epoch)
            self._live = self._fresh_live(snap)

    def _arm_merge_backoff(self, e: BaseException) -> MergeFailedError:
        """Count one contained merge failure and arm the capped exponential
        retry backoff; returns the ``MergeFailedError`` to raise. The
        incident report is the caller's (``_report_merge_failure``), made
        where the service lock is not held for it."""
        self.stats.merge_failures += 1
        self._consec_merge_failures += 1
        backoff = min(self.merge_backoff_cap_s,
                      self.merge_backoff_s *
                      2.0 ** (self._consec_merge_failures - 1))
        self._last_backoff = backoff
        self._merge_retry_at = time.monotonic() + backoff
        self._note_error(e)
        log.warning("merge failed (attempt %d, retry in %.3fs): %r; live "
                    "state untouched", self._consec_merge_failures,
                    backoff, e)
        return MergeFailedError(
            f"merge failed ({self._consec_merge_failures} consecutive "
            f"attempt(s)): {e!r}; the live state is untouched and the "
            "delta keeps serving")

    def _report_merge_failure(self, kind: str, e: BaseException) -> None:
        """The incident bundle of a contained merge failure (``kind``:
        ``merge.failure``, or ``merge.worker_death`` for a dead worker, so
        the two bundle apart). In sync mode the caller's ``merge`` holds
        the service lock throughout, as in the reference."""
        _report_incident(kind, repr(e), health=self.health,
                         consecutive=self._consec_merge_failures,
                         retry_in_s=round(self._last_backoff, 3))

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
        with _on_device(self.device):
            while True:
                self._merge_wakeup.wait()
                self._merge_wakeup.clear()
                if self._closed:
                    return
                try:
                    fire(POINT_MERGE_WORKER)
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
                    self._report_merge_failure("merge.worker_death", e)
                    log.warning("merge worker died: %r; a fresh worker "
                                "starts on the next update", e,
                                exc_info=True)
                    return

    def close(self) -> None:
        """Drain outstanding work, stop the merge worker (an in-flight merge
        finishes first: its durable commit needs the WAL) and release the
        WAL handle (the directory stays openable). Idempotent; the service
        is a context manager."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cancel_timer()
            self.drain()
            worker = self._merge_worker
            deadline_thread = self._deadline_thread
            self._cond.notify_all()
        # joined outside the lock: the worker's publish needs it, and the
        # deadline thread wakes holding it
        if worker is not None and worker.is_alive():
            self._merge_wakeup.set()
            worker.join()
        if deadline_thread is not None:
            deadline_thread.join()
        with self._lock:
            if self._dur is not None:
                self._dur.wal.close()
                self._dur = None

    # -- durability ----------------------------------------------------------
    @staticmethod
    def _commit_generation(root: pathlib.Path, gen: int, snap: Snapshot,
                           seed_ops, fsync: bool, *,
                           snapshot_saved: bool = False) -> _DurableState:
        """The durable commit, in one place: write generation ``gen``'s
        snapshot (unless ``snapshot_saved``: a merge wrote it off the
        lock), create its WAL seeded with ``seed_ops``
        (``DeltaBuffer.pending_ops`` order), then publish with one atomic
        manifest rename. Nothing is live until the rename; a caught failure
        sweeps the partial generation away."""
        wal = None
        try:
            if not snapshot_saved:
                save_snapshot(root / gen_name(gen), snap, fsync=fsync)
            wal = WriteAheadLog.create(root / wal_name(gen), fsync=fsync)
            for opname, op_keys in seed_ops:
                wal.append(_WAL_OPS[opname], op_keys)
            write_manifest(root, Manifest.for_generation(gen), fsync=fsync)
        except Exception:
            if wal is not None:
                wal.close()
            shutil.rmtree(root / gen_name(gen), ignore_errors=True)
            try:
                (root / wal_name(gen)).unlink()
            except OSError:
                pass
            raise
        return _DurableState(root=root, generation=gen, wal=wal,
                             fsync=fsync)

    def _swap_durable(self, new_dur: _DurableState) -> None:
        """Adopt a freshly committed generation (lock held): close the
        previous WAL handle and collect superseded on-disk state."""
        old = self._dur
        self._dur = new_dur
        if old is not None:
            old.wal.close()
        _gc_generations(new_dur.root, new_dur.generation,
                        self.keep_generations)

    def save(self, root, *, fsync: bool = True) -> pathlib.Path:
        """Persist the current (snapshot, delta) state under ``root`` and
        attach this service to it (durable mode): the snapshot as a new
        numbered generation, its WAL seeded with the live delta (deletes
        before inserts), the manifest published atomically. From here on
        every ``insert``/``delete`` is WAL-logged before it is applied and
        every merge commits a new generation; older ones are collected.
        Each call commits a fresh generation."""
        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        # serialised with merges (lock order _merge_mutex -> _lock): a
        # background merge mid-rebuild targets the next generation too
        with self._merge_mutex, self._lock:
            self.drain()
            state = self._state
            man = read_manifest(root)
            gen = man.generation + 1 if man is not None else 0
            self._swap_durable(self._commit_generation(
                root, gen, state.snapshot, state.delta.pending_ops(),
                fsync))
        return root

    @classmethod
    def open(cls, root, *, backend: str = "cuda", durable: bool = True,
             fsync: bool = True, verify: bool = False, recover: bool = True,
             device=None, **kw) -> "PlexService":
        """Start a service from a persisted directory in load time.

        Follows the manifest to the last committed generation, maps its
        snapshot (no rebuild of any kind: the planes go to ``device`` with
        the persisted statics), and replays the WAL's valid prefix into a
        fresh delta; crash leftovers (uncommitted generation dirs, stray
        WAL segments, torn WAL tails) are logged and discarded, a torn tail
        truncated before the segment is reused. ``durable=True`` keeps the
        service attached: updates append to the recovered WAL and merges
        commit generations. ``load_s`` is the whole open's wall time.

        Last-known-good recovery (``recover=True``): a corrupt manifest or
        a committed generation that fails to open is moved to
        ``root/quarantine/`` and the open falls back generation by
        generation to the newest older one that opens (retained by serving
        with ``keep_generations > 1``); a durable open then re-commits the
        manifest there. ``NoServableGenerationError``: every candidate
        failed; ``FileNotFoundError``: the directory was never published
        to. ``recover=False`` fails fast instead."""
        t0 = time.perf_counter()
        root = pathlib.Path(root)
        device = resolve_device(device)
        last_err: BaseException | None = None
        try:
            man = read_manifest(root)
        except CorruptManifestError as e:
            if not recover:
                raise
            log.warning("open(%s): manifest corrupt (%s); falling back to "
                        "the newest on-disk generation", root, e)
            last_err = e
            man = None
        if man is None and last_err is None:
            raise FileNotFoundError(f"no committed manifest under {root}")
        gens = sorted((g for p in root.glob("gen-*")
                       if p.is_dir() and (g := _gen_num(p)) is not None),
                      reverse=True)
        if man is not None:
            for g in gens:
                if g > man.generation:
                    log.warning("open(%s): discarding uncommitted "
                                "generation %s", root, gen_name(g))
            candidates = [man.generation] + [g for g in gens
                                             if g < man.generation]
        else:
            candidates = gens
        for p in sorted(root.glob("wal-*.log")):
            g = _gen_num(p)
            if man is not None and (g is None or g > man.generation):
                log.warning("open(%s): discarding stray WAL segment %s",
                            root, p.name)
        for p in sorted(root.glob("wal-*.log.rot")):
            # a crash between rotate()'s temp write and its rename leaves
            # this; the live segment is authoritative
            log.warning("open(%s): removing leftover rotation temp %s",
                        root, p.name)
            try:
                p.unlink()
            except OSError:  # pragma: no cover
                pass
        snap = None
        chosen = -1
        for g in candidates:
            gdir = root / gen_name(g)
            try:
                snap = load_snapshot(gdir, verify=verify, device=device)
                chosen = g
                break
            except Exception as e:
                if not recover:
                    raise
                last_err = e
                log.warning("open(%s): generation %s failed validation "
                            "(%r); quarantining and falling back", root,
                            gen_name(g), e)
                _quarantine(root, gdir, root / wal_name(g))
                _report_incident("generation.quarantine",
                                 f"{gen_name(g)}: {e!r}", root=str(root),
                                 generation=int(g))
        if snap is None:
            raise NoServableGenerationError(root, last_err)
        svc = cls(None, backend=backend, device=device, _snapshot=snap, **kw)
        wal_path = root / wal_name(chosen)
        records, valid, discarded = WriteAheadLog.replay(wal_path)
        if discarded:
            log.warning("open(%s): WAL %s: discarded %d trailing byte(s) "
                        "past the last valid record", root, wal_path.name,
                        discarded)
        # consecutive same-op records coalesced: each delta mutation
        # rebuilds the published state, so one op a run keeps recovery
        # linear in the WAL's size
        delta = svc._state.delta
        for op, op_keys in _coalesce_ops(records):
            if op == OP_INSERT:
                delta.insert(op_keys)
            else:
                delta.delete(op_keys)
        if durable:
            if man is None or chosen != man.generation:
                # recovery demoted the store to an older generation: commit
                # the manifest there, so appends bind to what is served
                write_manifest(root, Manifest.for_generation(chosen),
                               fsync=fsync)
            if wal_path.exists() and valid > 0:
                # valid > 0: the magic verified; drop the torn tail (if
                # any) and append after the good prefix
                wal = WriteAheadLog.open(wal_path, fsync=fsync,
                                         truncate_at=valid)
            else:
                # a missing segment or a bad magic: appending after a bad
                # header would make every new record unrecoverable
                log.warning("open(%s): WAL %s %s; starting a fresh segment",
                            root, wal_path.name,
                            "has an invalid header" if wal_path.exists()
                            else "is missing")
                wal = WriteAheadLog.create(wal_path, fsync=fsync)
            svc._dur = _DurableState(root=root, generation=chosen, wal=wal,
                                     fsync=fsync)
        svc.load_s = time.perf_counter() - t0
        if TRACE.enabled:
            TRACE.record("persist.open", svc.load_s,
                         generation=svc.generation)
        return svc

    @property
    def durable(self) -> bool:
        """Whether the service is attached to a persisted directory."""
        return self._dur is not None

    @property
    def generation(self) -> int:
        """The committed durable generation (-1 in memory only)."""
        return self._dur.generation if self._dur is not None else -1

    def __enter__(self) -> "PlexService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- the queue --------------------------------------------------------------
    def submit(self, q: np.ndarray) -> LookupTicket:
        """Queue queries for micro-batch formation across callers.

        Full blocks launch at once (asynchronously); a remainder launches
        once the oldest queued query has waited ``max_delay_s``, by the
        service's deadline thread if no further call comes; its pass also
        drains every launched block, so tickets fill with no further call.
        A submit arms the deadline with a field set under the lock: the one
        thread starts at the first arm and serves every later one. On the
        per-shard and routed paths
        the ticket is filled at once. With ``max_queue > 0`` a submit that
        would pass the bound is refused: ``overflow="reject"`` raises
        ``QueueFullError``, ``"shed"`` returns a ticket carrying it."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        ticket = LookupTicket(self, q.size)
        if q.size == 0:
            return ticket
        with TRACE.span("serve.submit", req=ticket.id, n=q.size):
            err = self._enqueue(q, ticket)
        if err is not None:
            # a refused submit: the bundle is written off the service lock
            _report_incident("queue.shed", str(err), health=self.health,
                             shed=int(q.size), overflow=self.overflow)
            if self.overflow == "reject":
                raise err
        return ticket

    def _enqueue(self, q: np.ndarray, ticket: LookupTicket
                 ) -> QueueFullError | None:
        """``submit``'s work under the service lock; returns the error of a
        submit refused by admission control (the ticket then carries it)."""
        req = ticket.id
        with TRACE.span("serve.lock", req=req):
            self._lock.acquire()
        try:
            if self.max_queue and self._q_len + q.size > self.max_queue:
                err = QueueFullError(
                    f"submit: queue holds {self._q_len} of "
                    f"{self.max_queue} lanes; {q.size} more would exceed "
                    "the bound")
                self.stats.shed_queries += q.size
                ticket._error = err
                ticket._filled, ticket._queued = q.size, 0
                return err
            # captured under the lock: mutations hold it too, so a queued
            # launch never pairs this snapshot with another epoch's delta
            st = self._state.stacked
            if st is None:
                ticket._out[:] = self.lookup(q)
                ticket._filled, ticket._queued = q.size, 0
                return None
            now = time.monotonic()
            self._q_chunks.append([ticket, q, 0, now])
            self._q_len += q.size
            self.stats.queries += q.size
            self._flush_full(st)
            if self._q_len:
                age = now - self._q_chunks[0][3]
                if age >= self.max_delay_s:
                    # an older chunk's deadline is armed: its pass drains
                    # these
                    self._flush_partial(st)
                else:
                    self._arm_timer(self.max_delay_s - age, req)
            else:
                # the queries filled whole blocks: the deadline's pass
                # drains them
                self._arm_timer(self.max_delay_s, req)
        finally:
            self._lock.release()
        return None

    def _arm_timer(self, delay_s: float, req: int | None = None) -> None:
        """Arm the deadline ``delay_s`` from now (one armed deadline at
        most; lock held); ``req``: the request that armed it. Starts the
        deadline thread if none is alive, and wakes it only if its wait
        would end after the new deadline."""
        if self._deadline is not None:
            return
        with TRACE.span("serve.timer", op="start", req=req):
            self._deadline = time.monotonic() + max(delay_s, 0.0)
            th = self._deadline_thread
            if th is None or not th.is_alive():
                th = threading.Thread(
                    target=_deadline_loop, name="plex-deadline", daemon=True,
                    args=(weakref.ref(self), self._cond, self.device))
                self._deadline_thread = th
                self.stats.deadline_threads += 1
                th.start()
            elif (self._sleep_until is not None
                  and self._sleep_until > self._deadline):
                self._cond.notify()
        self.stats.timers_started += 1

    def _cancel_timer(self, req: int | None = None) -> None:
        """Clear the armed deadline (lock held). The thread is not woken:
        its wait ends at the old deadline or sooner, and finds none."""
        if self._deadline is not None:
            with TRACE.span("serve.timer", op="cancel", req=req):
                self._deadline = None

    def _deadline_flush(self) -> None:
        """The deadline thread's pass, once the armed deadline has passed
        (the thread holds the lock): launch and drain the queued remainder
        (re-arm when its oldest query is younger than ``max_delay_s``), and
        drain the blocks a submit launched after the deadline was armed. A
        failure is parked on the tickets it concerns and logged here."""
        with TRACE.span("serve.deadline_flush") as sp:
            with TRACE.span("serve.lock"):
                self._lock.acquire()
            try:
                work = self._deadline_pass()
            finally:
                self._lock.release()
            sp.set(work=work)

    def _deadline_pass(self) -> bool:
        """One deadline pass under the lock; whether it launched or drained
        anything (counted either way)."""
        self._deadline = None
        work = bool(self._q_len or self._outstanding)
        if work and self._q_len:
            age = time.monotonic() - self._q_chunks[0][3]
            if age < self.max_delay_s:
                self._arm_timer(self.max_delay_s - age)
                work = False
        if not work:
            self.stats.deadline_idle += 1
            return False
        self.stats.deadline_flushes += 1
        try:
            self._flush_queue()
            self._drain_outstanding()
        except Exception:
            log.exception("deadline flush failed")
        return True

    def _take_block(self, want: int) -> tuple[np.ndarray, list, int]:
        """Pop up to ``want`` queued queries into a fresh block (fresh: a
        launched block stays in flight across calls); returns (block,
        ticket pieces, lanes filled)."""
        with TRACE.span("serve.take", lanes=want) as sp:
            buf = np.empty(want, dtype=np.uint64)
            pieces = []
            filled = 0
            obs = METRICS.enabled or TRACE.enabled
            now = time.monotonic() if obs else 0.0
            while filled < want and self._q_chunks:
                entry = self._q_chunks[0]
                ticket, arr, consumed, arrival = entry
                take = min(want - filled, arr.size - consumed)
                buf[filled:filled + take] = arr[consumed:consumed + take]
                pieces.append((ticket, filled, consumed, take))
                ticket._queued -= take
                entry[2] += take
                filled += take
                if obs:
                    wait_s = max(now - arrival, 0.0)
                    TRACE.record("serve.queue_wait", wait_s, req=ticket.id,
                                 lanes=take)
                    if METRICS.enabled:
                        METRICS.histogram("serve.queue_wait_us").observe(
                            wait_s * 1e6)
                if entry[2] == arr.size:
                    self._q_chunks.popleft()
            self._q_len -= filled
            if TRACE.enabled:
                sp.set(reqs=_reqs(pieces))
        return buf[:filled], pieces, filled

    def _queue_failed(self, e: BaseException) -> None:
        """Account one failed queue block of the default backend."""
        self.stats.backend_failures += 1
        self._note_error(e)
        self._record_breaker(self._breaker(self.default_backend), False, e)
        log.warning("queue: backend %r failed (%r); answering the block "
                    "through the fallback chain", self.default_backend, e)

    def _fill_pieces_fallback(self, buf: np.ndarray, pieces: list) -> None:
        """Answer one failed queue block synchronously through ``lookup``'s
        fallback chain and fill its ticket pieces; when the chain is
        exhausted the error parks on each ticket (raised by ``result()``:
        never a hang, never a partial result)."""
        try:
            out = self.lookup(buf)
        except Exception as e:
            for ticket, _, _, cnt in pieces:
                ticket._error = e
                ticket._filled += cnt
            return
        for ticket, src, dst, cnt in pieces:
            ticket._out[dst:dst + cnt] = out[src:src + cnt]
            ticket._filled += cnt

    def _fill_queue_sync(self) -> None:
        """Answer every queued chunk synchronously through the fallback
        chain (lock held): the default backend has no fused impl to queue
        on. Chain-exhausted failures park on the tickets."""
        while self._q_chunks:
            ticket, arr, consumed, _ = self._q_chunks.popleft()
            rest = arr[consumed:]
            self._q_len -= rest.size
            ticket._queued -= rest.size
            try:
                ticket._out[consumed:] = self.lookup(rest)
            except Exception as e:
                ticket._error = e
            ticket._filled += rest.size

    def _dispatch_queue_block(self, st: StackedTorchPlex, buf: np.ndarray,
                              pieces: list, filled: int) -> None:
        """Launch one queue block (one launch) and record its event; a
        failed launch answers the block through the fallback chain."""
        reqs = _reqs(pieces) if TRACE.enabled else None
        try:
            with TRACE.span("serve.staging", n=filled, reqs=reqs):
                qd = self._upload(buf)
            with TRACE.span("serve.dispatch", path="queue", n=filled,
                            reqs=reqs):
                res = st.lookup_planes(qd, n_valid=filled,
                                       delta=self._delta_view(self._state))
                ev = None
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(self.device))
        except Exception as e:
            self._queue_failed(e)
            self._fill_pieces_fallback(buf, pieces)
            return
        for ticket, _, _, _ in pieces:
            ticket._events.append(ev)
        self._outstanding.append((res, buf, pieces, self.stats.epoch, ev))
        self.stats.inflight_batches += 1
        self.stats.note(0, 1, 0)

    def _flush_full(self, st: StackedTorchPlex) -> None:
        while self._q_len >= self.block:
            self._dispatch_queue_block(st, *self._take_block(self.block))

    def _flush_partial(self, st: StackedTorchPlex) -> None:
        self._flush_full(st)
        if self._q_len:
            self._dispatch_queue_block(st, *self._take_block(self._q_len))

    def _flush_queue(self) -> None:
        """Launch the queued remainder on the current state's fused impl,
        or answer it synchronously when there is none (lock held)."""
        st = self._state.stacked
        if st is None:
            self._fill_queue_sync()
        else:
            self._flush_partial(st)

    def _drain_outstanding(self, deadline: float | None = None) -> None:
        """Wait for every launched queue block (its event), copy it back and
        fill its tickets (lock held). ``deadline`` bounds the waits: on
        expiry ``TimeoutError`` propagates with the remaining blocks left
        outstanding."""
        while self._outstanding:
            res, buf, pieces, epoch, ev = self._outstanding[0]
            reqs = _reqs(pieces) if TRACE.enabled else None
            with TRACE.span("serve.drain.wait", reqs=reqs):
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
                with TRACE.span("serve.copy_back", n=buf.size, reqs=reqs):
                    arr = res.out.cpu().numpy()
                with TRACE.span("serve.cache_count", reqs=reqs):
                    self._note_synced([res], epoch)
            except Exception as e:
                self._queue_failed(e)
                self._fill_pieces_fallback(buf, pieces)
                self.stats.note_drained(1)
                continue
            with TRACE.span("serve.fill", reqs=reqs):
                for ticket, src, dst, cnt in pieces:
                    ticket._out[dst:dst + cnt] = arr[src:src + cnt]
                    ticket._filled += cnt
                self.stats.note_drained(1)
                # the block's device result and host copy are freed here,
                # inside the span, rather than between the drain's spans
                del res, arr
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
        self._drain(timeout)

    def _drain(self, timeout: float | None, req: int | None = None) -> None:
        """``drain``; ``req``: the ticket whose ``result()`` drains, the
        request id of the drain's spans."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        with TRACE.span("serve.drain", req=req) as sp:
            with TRACE.span("serve.lock", req=req):
                if timeout is None:
                    self._lock.acquire()
                elif not self._lock.acquire(timeout=float(timeout)):
                    raise TimeoutError(
                        f"drain: service lock not acquired within "
                        f"{timeout}s")
            try:
                if TRACE.enabled:
                    sp.set(queued=self._q_len,
                           outstanding=len(self._outstanding))
                self._cancel_timer(req)
                if self._q_len:
                    self._flush_queue()
                self._drain_outstanding(deadline)
            finally:
                self._lock.release()

    # -- warm-up and measurement ----------------------------------------------
    def _warm(self, state: _ServiceState, backend: str | None = None) -> None:
        """Launch once each variant ``backend`` (the default one by default)
        serving ``state`` can take: on the fused path uncounted (cached,
        with ``cache_slots``) and counted, each delta-free and merged at the
        delta capacity (a zero-weight entry, which changes no result); on
        the routed path the same on every slot's stream; on the per-shard
        path every shard's impl, delta-free (its delta folds on the host).
        Not served traffic: no stats, and the warm counts are discarded."""
        backend = backend or self.default_backend
        snap = state.snapshot
        if state.router is not None and backend == self.default_backend:
            state.router.warmup(np.uint64(snap.keys[0]),
                                self._delta_capacity)
            return
        q = torch.from_numpy(to_biased(snap.keys[:1])).to(self.device)
        st = (state.stacked if backend == self.default_backend
              else self._stacked_for(snap, backend))
        if st is None:
            for s in range(snap.n_shards):
                self._shard_impl(snap, s, backend).lookup_planes(
                    q, counted=False)
            return
        dummy = build_delta_planes(snap.keys[:1], np.zeros(1, np.int64),
                                   self._delta_capacity, self.device)
        for delta in (None, dummy):
            for counted in (False, True):
                st.lookup_planes(q, delta=delta, counted=counted)
        st.take_counters()

    def warmup(self, backend: str | None = None) -> None:
        """Build ``backend``'s impls (the kernel library on the card) and
        launch each variant this epoch's serving takes once, so the first
        served request pays no build and no first launch. A failure of the
        service's own backend (a kernel library that does not build) is
        noted in ``health()`` and raised: no chain covers it up here.
        Another backend's is noted, logged and left cold."""
        backend = backend or self.default_backend
        try:
            if not get_backend(backend).stacked:
                return
            with _on_device(self.device):
                self._warm(self._state, backend)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        except Exception as e:
            self._note_error(e)
            if backend == self.default_backend:
                raise
            log.warning("warmup: backend %r failed (%r); left cold", backend,
                        e)

    def throughput(self, q: np.ndarray, backends: Sequence[str] | None = None,
                   repeats: int = 3) -> dict[str, float]:
        """Best-of-``repeats`` ns per lookup for each backend (every
        registered one by default), each warmed first. ``lookup`` ends in
        the copy back to the host, so the timed region covers the device
        work."""
        report: dict[str, float] = {}
        for backend in backends if backends is not None else backend_names():
            self.warmup(backend)
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                self.lookup(q, backend=backend)
                self.drain()
                best = min(best, time.perf_counter() - t0)
            report[backend] = best / q.size * 1e9
        return report
