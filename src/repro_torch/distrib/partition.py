"""Partitioned stacked planes: per-slot, shard-contiguous plane slabs (the
port of ``repro.distrib.partition``).

The stacked layout (``kernels.planes.build_stacked_planes``) fuses shard
planes into shard-major slabs on one device. The partitioner splits the
stacked build along a ``PlacementPlan``'s slot boundaries instead: each
slot gets one stacked impl (whichever backend the registry resolves: K1 on
the card, the plain pipeline with ``torch``) holding only its contiguous
shard range. A slot's placement address is a ``torch.device``; the device
list may repeat a device, and then each slot is a partition of its own on
that device, with its own slab and its own CUDA stream.

Two properties make the split free of new kernel work:

* Row offsets stay **global**: the stacked pipeline adds each shard's
  global key offset in the launch, so a slot's impl already returns global
  indices: no re-basing, no gather across slots, the same arithmetic as the
  single-device path.
* Unification is **per slot**: shards only need compatible static
  parameters with their slab-mates, so a snapshot whose shards cannot all
  be unified (radix and CHT shards mixed, say) may still partition into
  per-slot unifiable slabs.

Each partition owns one CUDA stream on its device (``None`` on the CPU).
Its slab is uploaded on that stream, and the routed lookup
(``distrib.routed_lookup``) stages, launches and copies back that slot's
micro-batches on it: slots' launches may run side by side on one card,
and no stream reads what another has not finished writing.

Empty slots (``n_devices > n_shards``) get a ``DevicePartition`` with no
impl and no stream; the plan never routes a query to them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.backends import get_backend
from ..kernels.planes import shards_unify
from ..resilience.errors import PartitionLoadError
from ..resilience.faults import POINT_PARTITION_LOAD, fire
from .placement import PlacementPlan, plan_matches


def slot_device(device) -> torch.device:
    """A placement address as a ``torch.device`` with its index (a bare
    ``"cuda"`` names the current card), so slots compare equal to the
    devices of the tensors they hold."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_stream(device: torch.device,
              stream) -> contextlib.AbstractContextManager:
    """``device`` and ``stream`` current for the work enqueued inside (a
    no-op without a stream: the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


@dataclasses.dataclass
class DevicePartition:
    """One slot of the plan: its device, its shard range, the slot-local
    stacked pipeline (``None`` for an empty slot: the plan never routes
    queries there) and its stream (``None`` on the CPU and for an empty
    slot)."""
    device: torch.device
    shard_lo: int
    shard_hi: int
    impl: Any                  # stacked impl (lookup_planes contract) | None
    stream: Any = None         # torch.cuda.Stream | None

    @property
    def n_shards(self) -> int:
        return self.shard_hi - self.shard_lo

    @property
    def empty(self) -> bool:
        return self.impl is None

    def on_stream(self) -> contextlib.AbstractContextManager:
        """This slot's device and stream current (no-op on the CPU)."""
        return on_stream(self.device, self.stream)


def new_stream(device: torch.device):
    """A stream of its own for a slot on ``device`` (``None`` on the
    CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def build_device_impl(shards: Sequence, row_off: np.ndarray, device, *,
                      block: int, probe: str | None = None,
                      cache_slots: int = 0, host_planes=None,
                      backend: str = "cuda", summary_keys: int | None = None,
                      stream=None):
    """One slot's stacked pipeline over ``shards`` (PLEX indexes) with
    *global* ``row_off``, its planes on ``device``, built by ``backend``'s
    registered stacked factory on ``stream`` (the slot's own; ``None`` on
    the CPU). ``summary_keys``: the keys of every slab that shares
    ``device`` (``build_stacked_planes``). Shared by the in-memory
    partitioner below and the partial-snapshot loader (``distrib.loader``),
    so both build identical slabs. ``None`` when the shards do not
    unify."""
    spec = get_backend(backend)
    if spec.stacked_factory is None:
        raise ValueError(f"backend {backend!r} has no stacked device path")
    device = slot_device(device)
    with on_stream(device, stream):
        return spec.stacked_factory(
            list(shards), np.asarray(row_off, dtype=np.int64), device=device,
            block=block, probe=probe, cache_slots=cache_slots,
            host_planes=host_planes, summary_keys=summary_keys)


def device_keys(plan: PlacementPlan, devices: Sequence) -> dict:
    """Keys each device holds over all the slots the plan puts on it (the
    ``summary_keys`` of those slots' slabs: they share the device's
    cache)."""
    total: dict = {}
    for d in range(plan.n_devices):
        lo, hi = plan.key_range(d)
        dev = slot_device(devices[d])
        total[dev] = total.get(dev, 0) + hi - lo
    return total


def partition_stacked(snap, plan: PlacementPlan, devices: Sequence, *,
                      block: int, probe: str | None = None,
                      cache_slots: int = 0, backend: str = "cuda"
                      ) -> list[DevicePartition] | None:
    """Split ``snap``'s stacked layout into per-slot slabs along ``plan``'s
    boundaries.

    Returns one ``DevicePartition`` per plan slot, or ``None`` when any
    non-empty slot's shards cannot be unified (the service then serves
    without a router, as it does when the single-device gate trips). The
    gate reads statics only and runs for every slot before any slab is
    built. ``devices`` is the slot list (a device may repeat); the plan
    must fit inside it. A failure building one slot (the
    ``distrib.partition.load`` fault point included) raises
    ``PartitionLoadError`` naming that slot.
    """
    if plan.n_devices > len(devices):
        raise ValueError(f"plan spans {plan.n_devices} devices but the "
                         f"device list has {len(devices)}")
    if not plan_matches(plan, snap.offsets, snap.keys.size, snap.shard_min):
        raise ValueError(
            "plan does not match this snapshot's shard table (stale plan "
            "from a previous snapshot? re-derive with plan_placement)")
    devs = [slot_device(d) for d in devices[:plan.n_devices]]
    for d in plan.active:
        lo, hi = plan.shard_range(int(d))
        try:
            # chaos point + typed wrap: a failure in THIS slot names it, so
            # the service can drop exactly it and re-plan onto the others
            fire(POINT_PARTITION_LOAD, device=int(d))
        except Exception as e:
            raise PartitionLoadError(int(d), devs[d], e) from e
        if not shards_unify(snap.shards[lo:hi], snap.offsets[lo:hi]):
            return None
    summary = device_keys(plan, devs)
    hp_fn = getattr(snap, "_host_planes_fn", None)
    parts: list[DevicePartition] = []
    for d in range(plan.n_devices):
        lo, hi = plan.shard_range(d)
        if lo == hi:
            parts.append(DevicePartition(devs[d], lo, hi, None))
            continue
        try:
            stream = new_stream(devs[d])
            impl = build_device_impl(
                snap.shards[lo:hi], snap.offsets[lo:hi], devs[d],
                block=block, probe=probe, cache_slots=cache_slots,
                host_planes=hp_fn(lo, hi) if hp_fn is not None else None,
                backend=backend, summary_keys=summary[devs[d]],
                stream=stream)
        except Exception as e:
            raise PartitionLoadError(d, devs[d], e) from e
        if impl is None:
            return None
        parts.append(DevicePartition(devs[d], lo, hi, impl, stream))
    return parts
