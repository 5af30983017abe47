"""PLEX: Practical Learned Index (the paper's §2 assembly), host build.

Build: eps-bounded greedy spline over the data -> auto-tune (paper §3) ->
build the chosen radix layer (flat radix table or CHT) over the spline keys.
The only user-facing hyperparameter is ``eps``; the index is guaranteed to be
at most twice the spline size.

This is the port's copy of ``repro.core.plex``: the build, and the host
lookup (``PLEX.lookup``, the ``"numpy"`` backend of ``LearnedIndex``) over the
fixed-trip ``bounded_lower_bound`` search, the branch-free form every device
search follows. Device lookups run in ``repro_torch.kernels``. Two faults of
the reference's host lookup are not copied: its float64 interpolation of
absolute keys (ROADMAP queue 3, R1; see ``spline.py``) and its int64 cast of
a prediction past the last key, which overflows for sparse splines (R2; the
port clips the prediction to the key range first).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Union

import numpy as np

from .autotune import TuneResult, tune
from .cht import CHT, build_cht
from .radix_table import RadixTable, build_radix_table
from .spline import Spline, build_spline


def bounded_lower_bound(keys: np.ndarray, q: np.ndarray, lo: np.ndarray,
                        hi: np.ndarray, *, side: str = "right") -> np.ndarray:
    """Vectorised branchless binary search restricted to [lo, hi] (inclusive).

    side="right": largest i in [lo, hi] with keys[i] <= q (predecessor;
    assumes keys[lo] <= q or the answer saturates at lo).
    side="left": smallest i in [lo, hi] with keys[i] >= q (lower bound;
    returns hi + 1 if no window key is >= q, matching searchsorted on a
    full [0, n-1] window).
    Fixed trip count ceil(log2(max window)).
    """
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    width = int(np.max(hi - lo)) if lo.size else 0
    if side == "right":
        # answer space [lo, hi]: width + 1 candidates
        trips = max(int(np.ceil(np.log2(width + 1))), 0) if width > 0 else 0
        for _ in range(trips):
            mid = (lo + hi + 1) >> 1
            go_hi = keys[np.minimum(mid, keys.size - 1)] <= q
            lo = np.where(go_hi, mid, lo)
            hi = np.where(go_hi, hi, mid - 1)
        return lo
    # answer space [lo, hi + 1]: width + 2 candidates (hi + 1 = "no window
    # key is >= q"), so one extra trip when width + 2 crosses a power of two
    trips = int(np.ceil(np.log2(width + 2))) if lo.size else 0
    for _ in range(trips):
        mid = (lo + hi) >> 1
        go_lo = keys[np.minimum(mid, keys.size - 1)] >= q
        hi = np.where(go_lo, mid, hi)
        lo = np.where(go_lo, lo, mid + 1)
    return lo


@dataclasses.dataclass
class BuildStats:
    spline_s: float
    tune_s: float
    layer_s: float
    total_s: float

    @classmethod
    def aggregate(cls, stats: "list[BuildStats]") -> "BuildStats":
        """Sum per-shard phase timings into one build-wide record: seconds
        of index work, not wall time (a parallel build overlaps the shards,
        so ``total_s / Snapshot.build_s`` is the realised parallelism).
        Loaded snapshots carry zeroed stats."""
        return cls(spline_s=sum(s.spline_s for s in stats),
                   tune_s=sum(s.tune_s for s in stats),
                   layer_s=sum(s.layer_s for s in stats),
                   total_s=sum(s.total_s for s in stats))


def freeze_arrays(*arrays: np.ndarray) -> None:
    """Mark numpy arrays immutable (``flags.writeable = False``).

    A snapshot never changes after construction: its device planes alias
    these arrays' contents, so a write would silently diverge from them.
    Freezing turns that into an immediate ``ValueError`` at the write site.
    """
    for a in arrays:
        if isinstance(a, np.ndarray):
            a.flags.writeable = False


@dataclasses.dataclass
class PLEX:
    spline: Spline
    layer: Union[RadixTable, CHT]
    tuning: TuneResult
    keys: np.ndarray          # the indexed (sorted, possibly duplicated) data
    eps: int
    stats: BuildStats

    @property
    def size_bytes(self) -> int:
        """Index size (spline + radix layer), paper's size metric."""
        return self.spline.size_bytes + self.layer.size_bytes

    def freeze(self) -> "PLEX":
        """Make every host array backing this index read-only (in place)."""
        layer_arr = (self.layer.table
                     if isinstance(self.layer, RadixTable)
                     else self.layer.cells)
        freeze_arrays(self.keys, self.spline.keys, self.spline.positions,
                      layer_arr)
        return self

    def segment_window(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Inclusive candidate window for the spline-segment search."""
        if isinstance(self.layer, RadixTable):
            return self.layer.lookup(q)
        qt = self.layer.lookup(q)
        hi = np.minimum(qt + self.layer.delta, self.spline.keys.size - 1)
        return qt, hi

    def predict(self, q: np.ndarray) -> np.ndarray:
        """Approximate rank with |predict - rank| <= eps for present keys."""
        q = np.asarray(q, dtype=np.uint64)
        lo, hi = self.segment_window(q)
        seg = bounded_lower_bound(self.spline.keys, q, lo, hi, side="right")
        seg = np.clip(seg, 0, self.spline.keys.size - 2)
        return self.spline.predict_in_segment(q, seg)

    def lookup(self, q: np.ndarray) -> np.ndarray:
        """Index of the first occurrence of each (present) query key.

        For absent keys returns the lower bound (first index with key >= q)
        clamped to the eps window — exact whenever the window is conclusive,
        which it always is for present keys (the paper's positive-lookup
        contract). The prediction is clipped to ``[0, n - 1]`` before its
        int64 cast: the window moves only where the reference's cast
        overflows (a key far past the end), and past the end it is then
        conclusive.
        """
        q = np.asarray(q, dtype=np.uint64)
        n = self.keys.size
        pred = np.clip(self.predict(q), 0, n - 1)
        lo = np.clip(np.floor(pred).astype(np.int64) - self.eps, 0, n - 1)
        hi = np.clip(np.ceil(pred).astype(np.int64) + self.eps, 0, n - 1)
        return bounded_lower_bound(self.keys, q, lo, hi, side="left")


def build_plex(keys: np.ndarray, eps: int, *,
               r_max_radix: int = 24, r_max_cht: int = 16,
               delta_max: int = 1024, tune_sample: int | None = None,
               budget_bytes: int | None = None) -> PLEX:
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    t0 = time.perf_counter()
    spline = build_spline(keys, eps)
    t1 = time.perf_counter()
    tuning = tune(spline, keys, r_max_radix=r_max_radix, r_max_cht=r_max_cht,
                  delta_max=delta_max, sample=tune_sample,
                  budget_bytes=budget_bytes)
    t2 = time.perf_counter()
    if tuning.kind == "radix":
        layer: Union[RadixTable, CHT] = build_radix_table(spline.keys, tuning.r)
    else:
        layer = build_cht(spline.keys, tuning.r, tuning.delta)
    t3 = time.perf_counter()
    return PLEX(spline=spline, layer=layer, tuning=tuning, keys=keys,
                eps=eps, stats=BuildStats(spline_s=t1 - t0, tune_s=t2 - t1,
                                          layer_s=t3 - t2, total_s=t3 - t0))
