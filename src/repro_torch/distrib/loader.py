"""Partial snapshot loads: per-slot warm starts that map only the bytes a
slot serves (the port of ``repro.distrib.loader``).

``persist.format.load_snapshot(shard_range=...)`` gives one slot a local
view of a committed generation that memmaps exactly the byte ranges its
placement assigns it. This module is the glue above it:

* ``plan_from_dir`` builds a ``PlacementPlan`` straight from the persisted
  header: per-shard key counts and spline/layer plane sizes live in the
  plane directory, so planning reads no bulk plane bytes (only the small
  offsets plane and one key per shard for the routing boundaries).
* ``open_device_partition`` partial-loads one slot's shard range and builds
  its slot-local stacked pipeline from the mapped planes and the persisted
  statics (the warm path full opens take), with global row offsets
  restored from the view's ``key_base``, on the slot's own stream.
* ``open_routed`` does that for every plan slot and assembles the
  ``RoutedStackedLookup``: on a deployment of several hosts each host runs
  the ``open_device_partition`` calls of its own slots only and never
  touches the rest of the file.

Generations are the reference's on-disk format, so either package plans
from and opens the other's.
"""
from __future__ import annotations

import logging
import pathlib
from typing import Sequence

import numpy as np

from ..core.index import Snapshot
from ..persist.format import (SNAPSHOT_FILE, _map_planes, _read_header,
                              load_snapshot)
from ..resilience.errors import PartitionLoadError
from ..resilience.faults import POINT_PARTITION_LOAD, fire
from .partition import (DevicePartition, build_device_impl, device_keys,
                        new_stream, slot_device)
from .placement import (PlacementPlan, _plan_from_arrays, plan_matches,
                        scale_by_hotness)
from .routed_lookup import RoutedStackedLookup

log = logging.getLogger("repro_torch.distrib")


def weights_from_header(header: dict) -> np.ndarray:
    """Planner weights from a persisted snapshot header: per-shard key
    count + spline points + radix/CHT cells, read from the plane directory;
    equal to ``placement.shard_weights`` on the live snapshot, so a
    coordinator planning from disk and a service planning from memory cut
    the same plan."""
    rows = {e["name"]: e for e in header["planes"]}
    w = np.empty(int(header["n_shards"]), dtype=np.float64)
    for i, sm in enumerate(header["shards"]):
        w[i] = (int(sm["n_real"]) + int(rows[f"s{i}.spline_keys"]["shape"][0])
                + int(rows[f"s{i}.layer"]["shape"][0]))
    return w


def _shard_table(gen_dir) -> tuple[dict, np.ndarray, np.ndarray]:
    """(header, offsets, shard minima) of a persisted generation: the
    header, the offsets plane and one key per shard, never a bulk plane."""
    path = pathlib.Path(gen_dir) / SNAPSHOT_FILE
    header, payload_base = _read_header(path)
    mm, _ = _map_planes(path, header, payload_base, {"offsets", "keys"})
    offsets = np.asarray(mm["offsets"], dtype=np.int64)
    return header, offsets, np.asarray(mm["keys"][offsets])


def plan_from_dir(gen_dir: str | pathlib.Path, n_devices: int, *,
                  hotness: np.ndarray | None = None) -> PlacementPlan:
    """Placement plan straight from a persisted generation directory.

    Reads the header, the offsets plane and one key per shard (the routing
    boundaries), never a bulk plane. ``hotness`` scales weights exactly as
    in ``plan_placement``."""
    header, offsets, shard_min = _shard_table(gen_dir)
    w = scale_by_hotness(weights_from_header(header), hotness)
    return _plan_from_arrays(offsets, int(header["n_keys"]), shard_min, w,
                             n_devices)


def open_device_partition(gen_dir: str | pathlib.Path, plan: PlacementPlan,
                          d: int, device, *, block: int,
                          probe: str | None = None, cache_slots: int = 0,
                          verify: bool = False, backend: str = "cuda",
                          summary_keys: int | None = None
                          ) -> tuple[DevicePartition, Snapshot | None]:
    """Partial-load slot ``d``'s shard range and build its slot-local
    pipeline on a stream of its own. Returns the partition and the partial
    snapshot behind it (``None`` for an empty slot; keep the snapshot alive
    while the partition serves: its maps back the planes' staging).
    ``summary_keys``: see ``build_device_impl`` (default: the slot's
    keys)."""
    lo, hi = plan.shard_range(d)
    device = slot_device(device)
    if lo == hi:
        return DevicePartition(device, lo, hi, None), None
    try:
        # chaos point + typed wrap, as in partition_stacked: a failed
        # partial load names its slot, so open_routed can drop exactly it
        fire(POINT_PARTITION_LOAD, device=d)
        snap = load_snapshot(gen_dir, shard_range=(lo, hi), verify=verify,
                             device=device)
        stream = new_stream(device)
        impl = build_device_impl(
            snap.shards, np.asarray(snap.offsets, np.int64) + snap.key_base,
            device, block=block, probe=probe, cache_slots=cache_slots,
            host_planes=snap._host_planes_fn(), backend=backend,
            summary_keys=summary_keys, stream=stream)
    except Exception as e:
        raise PartitionLoadError(d, device, e) from e
    if impl is None:
        raise ValueError(f"device {d}: shards [{lo}, {hi}) could not be "
                         f"unified into one stacked pipeline")
    return DevicePartition(device, lo, hi, impl, stream), snap


def open_routed(gen_dir: str | pathlib.Path, plan: PlacementPlan,
                devices: Sequence, *, block: int, probe: str | None = None,
                cache_slots: int = 0, verify: bool = False,
                backend: str = "cuda", on_device_failure: str = "raise"
                ) -> tuple[RoutedStackedLookup, list[Snapshot], int]:
    """Partial-load every plan slot and assemble the routed lookup.

    Returns (router, partial snapshots, total mapped bytes). The partial
    snapshots must outlive the router; ``mapped_bytes`` sums each slot's
    maps, which the tests hold strictly below one full load.

    ``on_device_failure`` chooses the reaction to a ``PartitionLoadError``:
    ``"raise"`` (default) propagates it; ``"replan"`` drops the failed slot
    from the device list, re-derives the plan over the survivors and
    retries (less capacity, identical results). With one device left the
    error propagates regardless: there is nothing to re-plan onto.
    """
    if on_device_failure not in ("raise", "replan"):
        raise ValueError(f"unknown on_device_failure {on_device_failure!r}")
    if plan.n_devices > len(devices):
        raise ValueError(f"plan spans {plan.n_devices} devices but got "
                         f"{len(devices)}")
    # bind-check the plan against THIS generation's shard table: a plan cut
    # from another generation would misroute silently
    header, offsets, shard_min = _shard_table(gen_dir)
    if not plan_matches(plan, offsets, int(header["n_keys"]), shard_min):
        raise ValueError(
            f"plan does not match the shard table persisted in {gen_dir} "
            "(stale plan from another generation? re-derive with "
            "plan_from_dir)")

    def _assemble(plan_cur: PlacementPlan, devs: list
                  ) -> tuple[RoutedStackedLookup, list[Snapshot], int]:
        devs = [slot_device(x) for x in devs[:plan_cur.n_devices]]
        summary = device_keys(plan_cur, devs)
        parts: list[DevicePartition] = []
        snaps: list[Snapshot] = []
        mapped = 0
        for d in range(plan_cur.n_devices):
            part, snap = open_device_partition(
                gen_dir, plan_cur, d, devs[d], block=block, probe=probe,
                cache_slots=cache_slots, verify=verify, backend=backend,
                summary_keys=summary[devs[d]])
            parts.append(part)
            if snap is not None:
                snaps.append(snap)
                mapped += snap.mapped_bytes
        return RoutedStackedLookup(plan_cur, parts, block), snaps, mapped

    devs = list(devices)
    plan_cur = plan
    while True:
        try:
            return _assemble(plan_cur, devs)
        except PartitionLoadError as e:
            if on_device_failure != "replan" or len(devs) <= 1:
                raise
            dropped = devs.pop(e.device_index)
            log.warning("open_routed(%s): device %d (%r) failed to load "
                        "(%s); re-planning onto %d surviving device(s)",
                        gen_dir, e.device_index, dropped, e.cause,
                        len(devs))
            plan_cur = plan_from_dir(
                gen_dir, min(plan_cur.n_devices, len(devs)))
