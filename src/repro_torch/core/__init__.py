"""PLEX host build and host lookup (numpy), the port's copy of
``repro.core``:

    build_spline -> tune -> build_radix_table | build_cht -> PLEX

``LearnedIndex`` looks one PLEX up on the device or the host; ``Snapshot``
shards the result and hands the serving pipeline its planes;
``parallel_build`` builds the shards over a process pool.
"""
from .autotune import TuneResult, cht_cost_model, radix_cost_model, tune
from .cht import CHT, adjacent_lcp, bit_length_u64, build_cht
from .index import BACKENDS, SHARD_MAX_KEYS, LearnedIndex, Snapshot, \
    shard_offsets
from .plex import PLEX, BuildStats, bounded_lower_bound, build_plex, \
    freeze_arrays
from .radix_table import RadixTable, build_radix_table, range_bits
from .spline import Spline, build_spline

__all__ = [
    "BACKENDS", "BuildStats", "CHT", "LearnedIndex", "PLEX", "RadixTable",
    "SHARD_MAX_KEYS", "Snapshot",
    "Spline", "TuneResult", "adjacent_lcp", "bit_length_u64",
    "bounded_lower_bound", "build_cht", "build_plex", "build_radix_table",
    "build_spline", "cht_cost_model", "freeze_arrays", "radix_cost_model",
    "range_bits", "shard_offsets", "tune",
]
