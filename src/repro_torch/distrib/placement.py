"""Shard placement planner: snapshot statics -> a slot-balanced plan (the
port's copy of ``repro.distrib.placement``).

The build-time distribution analysis PLEX already does (spline density,
radix/CHT cell counts, per-shard key counts) tells, before a query is ever
served, how much plane memory and probe work each shard costs.
``plan_placement`` turns those statics into a ``PlacementPlan``: a
contiguous assignment of shards to ``n_devices`` placement slots that
minimises the largest slot weight (the classic contiguous partition, solved
exactly by a binary search over the bottleneck capacity with greedy
packing). A slot is a device of the serving list: a card of its own, or one
of several slots on one card (``distrib.partition``).

Contiguity is load-bearing: shards are key-ordered, so a contiguous
assignment makes slot routing the same predecessor count over minima that
shard routing already is, one ``searchsorted`` over the plan's boundary
keys on the host (``PlacementPlan.device_of``), and no traffic between
devices after it. A hash or round-robin placement would balance as well but
force an all-to-all between routing and lookup.

Weights default to ``n_keys + n_spline + layer_cells`` per shard (the
dominant plane bytes plus the search-structure gathers) and can be scaled
by a per-shard hotness estimate (``shard_hotness`` counts routed queries of
any sample stream; a skew-aware plan then packs fewer hot shards per slot).
Plans are host-only numpy state: building one touches no device and no bulk
key bytes, which lets a coordinator plan straight from a persisted snapshot
header (``distrib.loader``).

Degenerate cases are first-class: ``n_devices == 1`` puts every shard on
slot 0, and ``n_devices > n_shards`` leaves the surplus slots empty; empty
slots are left out of the routing boundary table, so no query reaches them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.metrics import METRICS
from ..obs.trace import TRACE


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Immutable slot -> shard-range assignment.

    ``shard_start``/``key_start`` have length ``n_devices + 1``: device
    ``d`` serves shards ``[shard_start[d], shard_start[d+1])`` covering
    global key rows ``[key_start[d], key_start[d+1])``. Empty ranges are
    allowed (surplus devices). ``active`` lists the non-empty devices and
    ``bound_keys[i]`` is the first snapshot key of ``active[i]`` — the
    host routing table (`device_of`). ``weights`` is the planner's
    per-device assigned weight (telemetry; the balance tests pin it).
    """
    n_devices: int
    shard_start: np.ndarray       # int64 [n_devices + 1]
    key_start: np.ndarray         # int64 [n_devices + 1]
    active: np.ndarray            # int64 [n_active] device ids, ascending
    bound_keys: np.ndarray        # uint64 [n_active] first key per active dev
    weights: np.ndarray           # float64 [n_devices]

    def __post_init__(self):
        for arr in (self.shard_start, self.key_start, self.active,
                    self.bound_keys, self.weights):
            arr.flags.writeable = False

    @property
    def n_shards(self) -> int:
        return int(self.shard_start[-1])

    @property
    def n_active(self) -> int:
        return int(self.active.size)

    def shard_range(self, d: int) -> tuple[int, int]:
        """Contiguous shard range [lo, hi) served by device ``d``."""
        return int(self.shard_start[d]), int(self.shard_start[d + 1])

    def key_range(self, d: int) -> tuple[int, int]:
        """Global key-row range [lo, hi) served by device ``d``."""
        return int(self.key_start[d]), int(self.key_start[d + 1])

    def row_slice(self, d: int, row_len: int) -> slice:
        """Device ``d``'s row slice of a shard-major stacked plane whose
        per-shard row length is ``row_len`` (e.g. ``n_data_max``) — the
        byte math behind partial plane placement."""
        lo, hi = self.shard_range(d)
        return slice(lo * row_len, hi * row_len)

    def device_of(self, q: np.ndarray) -> np.ndarray:
        """Owning device id per query: predecessor count over the active
        devices' boundary keys (the device-level analogue of
        ``Snapshot.route``; below-min queries clip to the first active
        device, matching the shard router's clip)."""
        q = np.asarray(q, dtype=np.uint64)
        slot = np.clip(np.searchsorted(self.bound_keys, q, side="right") - 1,
                       0, self.n_active - 1)
        return self.active[slot]

    def describe(self) -> str:
        parts = []
        for d in range(self.n_devices):
            lo, hi = self.shard_range(d)
            klo, khi = self.key_range(d)
            parts.append(f"dev{d}: shards[{lo}:{hi}] keys[{klo}:{khi}] "
                         f"w={self.weights[d]:.0f}")
        return "\n".join(parts)


def plan_matches(plan: PlacementPlan, offsets: np.ndarray,
                 n_keys_total: int, shard_min: np.ndarray) -> bool:
    """True iff ``plan`` was cut from exactly this shard table (same shard
    count, same global key edges, same routing boundary keys).

    A plan is snapshot-scoped state: after a merge rebuilds the snapshot,
    even an identical shard *count* pairs with shifted offsets and minima,
    and routing with the stale boundaries would silently misbin queries.
    Every consumer that accepts a caller-supplied plan (the service's
    pinned-plan path, ``partition_stacked``, ``loader.open_routed``)
    checks this binding instead of the count alone.
    """
    offs = np.asarray(offsets, dtype=np.int64)
    if plan.n_shards != offs.size:
        return False
    key_edges = np.concatenate([offs, [np.int64(n_keys_total)]])
    if not np.array_equal(plan.key_start, key_edges[plan.shard_start]):
        return False
    mins = np.asarray(shard_min, dtype=np.uint64)
    return np.array_equal(plan.bound_keys,
                          mins[plan.shard_start[plan.active]])


def partition_contiguous(weights: np.ndarray, n_parts: int) -> np.ndarray:
    """Boundaries of an optimal contiguous partition of ``weights`` into at
    most ``n_parts`` parts minimising the maximum part sum.

    Binary search over the bottleneck capacity with a greedy feasibility
    check — exact for this objective. Returns int64 boundaries of length
    ``n_parts + 1`` (monotone; trailing parts may be empty when fewer
    parts suffice, e.g. ``n_parts > len(weights)``).
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.size == 0 or n_parts < 1:
        raise ValueError("need >= 1 weight and >= 1 part")
    if np.any(w < 0):
        raise ValueError("weights must be non-negative")

    def parts_needed(cap: float) -> int:
        n, cur = 1, 0.0
        for x in w:
            if cur + x > cap:
                n += 1
                cur = x
            else:
                cur += x
        return n

    lo, hi = float(w.max()), float(w.sum())
    for _ in range(100):                    # float bisection to fixed point
        mid = (lo + hi) / 2
        if parts_needed(mid) <= n_parts:
            hi = mid
        else:
            lo = mid
    cap = hi * (1 + 1e-12)
    bounds = [0]
    cur = 0.0
    for i, x in enumerate(w):
        if cur + x > cap and bounds[-1] < i:
            bounds.append(i)
            cur = x
        else:
            cur += x
    bounds.append(w.size)
    while len(bounds) < n_parts + 1:        # surplus devices stay empty
        bounds.append(w.size)
    return np.asarray(bounds, dtype=np.int64)


def scale_by_hotness(weights: np.ndarray,
                     hotness: np.ndarray | None) -> np.ndarray:
    """Scale planner weights by a per-shard access estimate, normalised to
    mean 1 so cold plans and hot plans stay comparable. Shared by the
    snapshot and persisted-header planning paths (``plan_from_dir``), so
    validation and scaling can never diverge between them."""
    if hotness is None:
        return weights
    h = np.asarray(hotness, dtype=np.float64)
    if h.shape != weights.shape:
        raise ValueError(f"hotness shape {h.shape} != shards "
                         f"{weights.shape}")
    if np.any(h < 0):
        raise ValueError("hotness must be non-negative")
    mean = h.mean()
    return weights * (h / mean) if mean > 0 else weights


def shard_weights(snap, *, hotness: np.ndarray | None = None) -> np.ndarray:
    """Planner weight per shard from snapshot statics: key count (the
    dominant plane-slab bytes) + spline points + radix/CHT cells (the
    search-structure gathers). ``hotness`` (any non-negative per-shard
    access estimate, e.g. from ``shard_hotness``) scales each weight by
    its share of traffic via ``scale_by_hotness``."""
    offs = np.asarray(snap.offsets, dtype=np.int64)
    n_keys = np.diff(np.concatenate([offs, [snap.keys.size]]))
    w = n_keys.astype(np.float64)
    for i, px in enumerate(snap.shards):
        cells = (px.layer.table if hasattr(px.layer, "table")
                 else px.layer.cells)
        w[i] += px.spline.keys.size + cells.size
    return scale_by_hotness(w, hotness)


def live_hotness(counts, n_shards: int) -> np.ndarray | None:
    """Validate a live per-shard routed-query fold (the device counter
    plane the observability layer accumulates) into a planner-ready
    hotness array, or ``None`` when it cannot inform a plan.

    The live estimate is best-effort by contract — it may be absent
    (observability never armed), stale across a merge that changed the
    shard count, or empty (no counted traffic yet). All of those return
    ``None`` so the caller falls back to statics-only weights instead of
    raising mid-replan; ``scale_by_hotness`` stays the strict validator
    for explicitly-passed hotness."""
    if counts is None:
        return None
    h = np.asarray(counts, dtype=np.float64)
    if h.ndim != 1 or h.size != int(n_shards):
        return None
    if not np.all(np.isfinite(h)) or np.any(h < 0):
        return None
    if h.sum() <= 0:
        return None
    return h


def shard_hotness(snap, sample: np.ndarray) -> np.ndarray:
    """Per-shard query counts of a sample stream (routed through the
    snapshot's shard table) — the optional skew input to ``plan_placement``.
    Any representative stream works: recent production queries, a Zipf
    synthetic, or replayed logs."""
    sid = snap.route(np.asarray(sample, dtype=np.uint64))
    return np.bincount(sid, minlength=snap.n_shards).astype(np.float64)


def _plan_from_arrays(offsets: np.ndarray, n_keys_total: int,
                      shard_min: np.ndarray, weights: np.ndarray,
                      n_devices: int) -> PlacementPlan:
    """Shared plan assembly for the snapshot and header paths."""
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    bounds = partition_contiguous(weights, n_devices)
    key_edges = np.concatenate([np.asarray(offsets, np.int64),
                                [np.int64(n_keys_total)]])
    key_start = key_edges[bounds]
    dev_w = np.asarray([weights[bounds[d]:bounds[d + 1]].sum()
                        for d in range(n_devices)])
    active = np.flatnonzero(np.diff(bounds) > 0).astype(np.int64)
    bound_keys = np.asarray(shard_min, np.uint64)[bounds[active]]
    bottleneck = float(dev_w.max()) if dev_w.size else 0.0
    if METRICS.enabled:
        METRICS.counter("placement.plans").inc()
        METRICS.gauge("placement.n_active").set(float(active.size))
        METRICS.gauge("placement.bottleneck_weight").set(bottleneck)
    if TRACE.enabled:
        # one marker per (re)plan: device-loss re-plans and hotness-driven
        # rebalances both show up in the flight recorder's span ring
        TRACE.event("placement.plan", n_devices=n_devices,
                    n_shards=int(weights.size), n_active=int(active.size),
                    bottleneck_weight=bottleneck)
    return PlacementPlan(n_devices=n_devices, shard_start=bounds,
                         key_start=key_start, active=active,
                         bound_keys=bound_keys, weights=dev_w)


def plan_placement(snap, n_devices: int, *,
                   hotness: np.ndarray | None = None) -> PlacementPlan:
    """Bin-pack ``snap``'s shards onto ``n_devices`` mesh devices.

    Host-only: reads the snapshot's statics (offsets, shard minima, layer
    sizes), never its bulk key bytes or any device plane. A 1-device plan
    assigns every shard to device 0 — the serving layer's bit-identity
    gate with the legacy single-device path rests on that.
    """
    w = shard_weights(snap, hotness=hotness)
    return _plan_from_arrays(snap.offsets, snap.keys.size, snap.shard_min,
                             w, n_devices)
