"""Routed lookup over per-slot plane slabs (the port of
``repro.distrib.routed_lookup``).

The placed serving path. Division of labour:

* **Host staging** biases the batch, bins it to its slots with a
  predecessor count over the plan's boundary keys
  (``PlacementPlan.device_of``'s answer), stable-sorts it into per-slot
  runs (nothing to sort with one active slot) and gathers it into one host
  buffer (pinned on the card). The binning, sort, gather and the final
  scatter are PyTorch CPU ops on its intra-op threads: at 2^20 queries
  they take a fraction of numpy's single-threaded searchsorted, argsort
  and fancy indexing.
* **Each slot**, on its own stream, uploads its run, launches its stacked
  pipeline once per ``block``-sized micro-batch (K1 on the card: route over
  the slot's shard minima, radix/CHT window, spline predecessor, eps probe,
  clamp, global offset and the merged delta fold, all in the launch) and
  copies its results back into a pinned buffer, then records an event.
  Every slot's work is enqueued before any wait, so the slots' launches
  overlap on the card. Row offsets are global (``distrib.partition``), so
  every slot returns final indices; nothing crosses between slots inside a
  dispatch: each launch reads only its slot's planes and queries.
* **Assembly** waits for every slot's event (the one sync of the batch)
  and inverts the staging permutation on the host.

The delta planes are replicated to every serving slot (bounded by the merge
threshold, so a copy is small beside a slab), each copy made on the slot's
stream after the source's upload, and cached per published delta view: an
unchanged delta costs no copy per lookup, and a mutation invalidates every
slot's replica at once. The staging buffers are pinned host memory handed
out by PyTorch's caching host allocator, which gives a buffer out again only
after the events recorded behind every copy that read or wrote it, so no
later lookup overwrites queries a slot's stream has not uploaded yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..kernels.keys import to_biased
from ..kernels.planes import DeltaPlanes, build_delta_planes
from ..kernels.stacked_lookup import LaneResult
from .partition import DevicePartition
from .placement import PlacementPlan



@dataclasses.dataclass
class RoutedBatch:
    """One routed batch in flight: the per-slot lane results and their copy
    back to the host, with what ``assemble`` needs to restore input
    order."""
    order: torch.Tensor | None         # staging sort (None: identity)
    # (start, n, lanes, host results, event | None) per served slot
    spans: list[tuple[int, int, list[LaneResult], torch.Tensor, Any]]
    n_batches: int
    padded_lanes: int = 0              # always 0: every lane is a query

    def assemble(self, n: int) -> np.ndarray:
        """THE sync point: wait for every slot's copy back and invert the
        staging permutation."""
        out_sorted = torch.empty(n, dtype=torch.int64)
        for start, count, _, host, ev in self.spans:
            if ev is not None:
                ev.synchronize()
            out_sorted[start:start + count] = host
        if self.order is None:
            return out_sorted.numpy()
        return torch.empty_like(out_sorted).index_copy_(
            0, self.order, out_sorted).numpy()

    def lane_results(self):
        for _, _, lanes, _, _ in self.spans:
            yield from lanes


def slot_bounds(plan: PlacementPlan) -> torch.Tensor:
    """The biased first keys of the plan's active slots after the first:
    the boundaries ``slot_positions`` counts."""
    return torch.from_numpy(to_biased(plan.bound_keys[1:]))


def slot_positions(qb: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Each biased query's slot as a position in ``plan.active`` (int32),
    the count of boundaries (``slot_bounds``) at or below it:
    ``plan.active[pos] == plan.device_of(q)``. Below the first slot's key a
    query goes to the first active slot, as ``device_of`` clips it."""
    return torch.bucketize(qb, bounds, right=True, out_int32=True)


def _stage(qb: torch.Tensor, order: torch.Tensor | None,
           pinned: bool) -> torch.Tensor:
    """The biased queries in slot order: gathered into pinned memory on the
    card (the uploads are asynchronous), a plain tensor on the CPU."""
    if not pinned:
        return qb if order is None else qb[order]
    buf = torch.empty(qb.numel(), dtype=torch.int64, pin_memory=True)
    if order is None:
        return buf.copy_(qb)
    return torch.index_select(qb, 0, order, out=buf)


def _replicate(dp: DeltaPlanes, part: DevicePartition) -> DeltaPlanes:
    """``dp`` on ``part``'s device, copied on its stream after the work
    queued on the source's stream (its upload); the source tensors are
    marked used by that stream, so their memory is not handed out again
    before the copy has read them. On the CPU the planes are shared."""
    if part.stream is None and dp.keys.device == part.device:
        return dp
    src = (torch.cuda.current_stream(dp.keys.device)
           if dp.keys.is_cuda else None)
    with part.on_stream():
        if src is not None:
            part.stream.wait_stream(src)
            dp.keys.record_stream(part.stream)
            dp.cum0.record_stream(part.stream)
        return DeltaPlanes(
            keys=dp.keys.to(part.device, copy=True, non_blocking=True),
            cum0=dp.cum0.to(part.device, copy=True, non_blocking=True),
            cap=dp.cap, n_entries=dp.n_entries)


class RoutedStackedLookup:
    """Routed merged lookup: a plan plus per-slot stacked slabs.

    ``parts`` is the full per-slot partition (one entry per plan slot,
    empty slots included). The instance owns the per-slot delta replicas'
    cache; everything else is immutable after construction and retires
    with its snapshot at a swap, as the single-device stacked impl does.
    """

    def __init__(self, plan: PlacementPlan, parts: Sequence[DevicePartition],
                 block: int):
        if len(parts) != plan.n_devices:
            raise ValueError(f"{len(parts)} partitions != plan's "
                             f"{plan.n_devices} devices")
        self.plan = plan
        self.parts = list(parts)
        self.block = int(block)
        self._bounds = slot_bounds(plan)
        self._pinned = any(p.stream is not None for p in self.parts)
        # (source view, {slot: replica}) published as ONE tuple, so a
        # lock-free reader never pairs a replica with another view
        self._delta_cache: tuple[Any, dict[int, DeltaPlanes]] | None = None

    @property
    def n_devices(self) -> int:
        return self.plan.n_devices

    @property
    def n_active(self) -> int:
        return self.plan.n_active

    def _replicas_for(self, dp: DeltaPlanes) -> dict[int, DeltaPlanes]:
        """The per-slot replica table of source view ``dp``, cached by the
        view's identity (the delta buffer builds a fresh view per mutated
        state, so identity is state). A reader holding another view builds
        a table of its own rather than resetting a shared one; same-view
        readers may race to fill a slot with identical copies."""
        cache = self._delta_cache
        if cache is None or cache[0] is not dp:
            cache = (dp, {})
            self._delta_cache = cache
        return cache[1]

    def dispatch(self, q: np.ndarray, delta: DeltaPlanes | None = None
                 ) -> RoutedBatch:
        """Bin ``q`` to slots and enqueue every slot's upload, launches and
        copy back (asynchronous on the card); no wait happens here. Call
        ``RoutedBatch.assemble`` (or ``lookup``) for the one blocking
        materialisation."""
        qb = torch.from_numpy(to_biased(np.asarray(q, dtype=np.uint64)))
        n_active = self.plan.n_active
        if n_active == 1:
            order, counts = None, [qb.numel()]
        else:
            slot = slot_positions(qb, self._bounds)
            if n_active <= 256:
                # torch's stable argsort is over twice as fast on bytes
                slot = slot.to(torch.uint8)
            order = torch.argsort(slot, stable=True)
            counts = torch.bincount(slot, minlength=n_active).tolist()
        staged = _stage(qb, order, self._pinned)
        # one replica-table capture per batch: every slot's fold below uses
        # the delta view this dispatch was called with
        reps = self._replicas_for(delta) if delta is not None else None
        spans = []
        n_batches = pos = 0
        for d, n_d in zip(self.plan.active, counts):
            d, n_d = int(d), int(n_d)
            if n_d == 0:
                continue
            part = self.parts[d]
            dp = None
            if reps is not None:
                dp = reps.get(d)
                if dp is None:
                    dp = reps[d] = _replicate(delta, part)
            with part.on_stream():
                qd = staged[pos:pos + n_d].to(part.device, non_blocking=True)
                lanes = part.impl.dispatch(qd, dp)
                res = (lanes[0].out if len(lanes) == 1
                       else torch.cat([r.out for r in lanes]))
                ev = None
                if part.stream is not None:
                    host = torch.empty(n_d, dtype=res.dtype, pin_memory=True)
                    host.copy_(res, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(part.stream)
                else:
                    host = res
            spans.append((pos, n_d, lanes, host, ev))
            n_batches += len(lanes)
            pos += n_d
        return RoutedBatch(order=order, spans=spans, n_batches=n_batches)

    def lookup(self, q: np.ndarray, delta: DeltaPlanes | None = None
               ) -> tuple[np.ndarray, RoutedBatch]:
        """Whole-batch routed (merged) lookup: global int64 indices in input
        order, plus the batch bookkeeping (launch counts and cache
        telemetry) for the service's stats."""
        batch = self.dispatch(q, delta)
        return batch.assemble(len(q)), batch

    def warmup(self, sample_key: np.uint64,
               delta_cap: int | None = None) -> None:
        """Launch once, on its stream, each variant an active slot serves
        with: uncounted and counted, and with ``delta_cap`` also merged at
        that capacity (a zero-weight entry, which changes no result); then
        wait for every slot. The warm counts are discarded."""
        for d in self.plan.active:
            part = self.parts[int(d)]
            with part.on_stream():
                key = np.asarray([sample_key], np.uint64)
                qd = torch.from_numpy(to_biased(key)).to(part.device)
                deltas = [None]
                if delta_cap:
                    deltas.append(build_delta_planes(
                        key, np.zeros(1, np.int64), delta_cap, part.device))
                for dp in deltas:
                    for counted in (False, True):
                        part.impl.lookup_planes(qd, delta=dp,
                                                counted=counted)
            if part.stream is not None:
                part.stream.synchronize()
            part.impl.take_counters()
