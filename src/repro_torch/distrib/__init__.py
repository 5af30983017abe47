"""Distribution (the port of ``repro.distrib``): placement planning,
per-slot partitioned planes, routed lookups with no traffic between slots,
and partial snapshot loads.

``placement`` turns snapshot statics into a balanced ``PlacementPlan``;
``partition`` splits the stacked plane layout into per-slot
shard-contiguous slabs, each with its own stream; ``routed_lookup`` serves
merged lookups (host binning, slot-local K1 launches, host
re-permutation); ``loader`` warm-starts each slot from only the snapshot
bytes its plan assigns it. A slot is a ``torch.device`` of the serving
list; a list that repeats one card runs several slots on it.
"""
from .loader import (open_device_partition, open_routed, plan_from_dir,
                     weights_from_header)
from .partition import DevicePartition, build_device_impl, partition_stacked
from .placement import (PlacementPlan, partition_contiguous, plan_matches,
                        plan_placement, scale_by_hotness, shard_hotness,
                        shard_weights)
from .routed_lookup import RoutedBatch, RoutedStackedLookup

__all__ = [
    "DevicePartition", "PlacementPlan", "RoutedBatch", "RoutedStackedLookup",
    "build_device_impl", "open_device_partition", "open_routed",
    "partition_contiguous", "partition_stacked", "plan_from_dir",
    "plan_matches", "plan_placement", "scale_by_hotness", "shard_hotness",
    "shard_weights", "weights_from_header",
]
