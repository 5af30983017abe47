"""PLEX auto-tuning: cost models for radix table and CHT (paper §3).

Host code of the port, identical to ``repro.core.autotune``.

Predicts average lookup cost and exact memory for *every* candidate radix
layer without building any of them:

* Radix table (Eq. 1): for each ``r``, the binary-search window of each data
  key is derived from two ``searchsorted`` calls against the spline-key
  prefixes — the cost is weighted by *data* keys, as in the paper.
* CHT (Eq. 2 / Algorithm 1): a single lcp-histogram over adjacent spline keys
  yields, per ``r``, the key-count of every bin at every level (maximal runs
  of ``lcp >= level*r``); suffix sums convert "bin with m keys splits iff
  m > delta" into average tree depth for *all* delta at once. Weighted by
  spline keys, the paper's stated simplification.

Both models are *exact* with respect to the structures ``build_radix_table``
and ``build_cht`` produce — tests assert equality against brute-force walks of
the built structures (this is the testable form of the paper's "empirically
verified that auto-tuning finds the grid-search optimum").

Deviations from the paper's pseudocode: window sizes carry a
``+1`` boundary slot (``[q~, q~+delta]`` inclusive), so search cost is
``ceil_log2(window+1)``; depth counts strict descents below the root (the
root access is common to every candidate and cancels in the argmin).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cht import adjacent_lcp, bit_length_u64
from .radix_table import range_bits
from .spline import Spline


def ceil_log2(x: np.ndarray) -> np.ndarray:
    """ceil(log2(x)) for integer x >= 1, exact (0 for x == 1)."""
    x = np.asarray(x, dtype=np.uint64)
    return bit_length_u64(np.maximum(x, np.uint64(1)) - np.uint64(1))


def radix_cost_model(spline_keys: np.ndarray, data_keys: np.ndarray,
                     r_max: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(lambda_r, bytes_r) for r in [1, min(r_max, range_bits, 22)] (Eq. 1).

    Exact single-histogram formulation: all data keys in a bucket share the
    bucket's search window, so Eq. 1 = sum_p count_p * ceil_log2(w_p) / |D|.
    One bincount of data-key prefixes at the finest r serves every coarser r
    by block-summing — O(|D| + sum_r 2^r) instead of O(r_max * |D| log |S|),
    which is what keeps PLEX's build (which INCLUDES tuning) within sight of
    RS's, the paper's Fig. 2 point. r is capped at 22 (a 4M-entry histogram;
    a bigger radix table would need a >16 MB spline budget anyway)."""
    sk = np.asarray(spline_keys, dtype=np.uint64)
    dk = np.asarray(data_keys, dtype=np.uint64)
    bits = range_bits(sk)
    r_hi = min(r_max, bits, 22)
    lams = np.full(r_hi + 1, np.inf)
    byts = np.zeros(r_hi + 1, dtype=np.int64)
    rel_s = sk - sk[0]
    rel_d = np.where(dk > sk[0], dk - sk[0], np.uint64(0))
    # int64 cast is exact (prefixes < 2^22); numpy 2.x bincount rejects u64
    hist = np.bincount((rel_d >> np.uint64(bits - r_hi)).astype(np.int64),
                       minlength=1 << r_hi).astype(np.int64)
    n = dk.size
    for r in range(1, r_hi + 1):
        sp = rel_s >> np.uint64(bits - r)
        edges = np.searchsorted(sp, np.arange((1 << r) + 1, dtype=np.uint64))
        lo = np.maximum(edges[:-1] - 1, 0)
        hi = np.maximum(edges[1:] - 1, 0)
        w = ceil_log2(hi - lo + 1)
        cnt = hist.reshape(1 << r, -1).sum(axis=1)
        lams[r] = float(np.dot(cnt, w)) / n
        byts[r] = 4 * ((1 << r) + 1)
    return lams, byts, r_hi


def _run_key_counts(mask: np.ndarray) -> np.ndarray:
    """Key counts (run length + 1) of maximal True-runs in a bool array."""
    padded = np.empty(mask.size + 2, dtype=np.int8)
    padded[0] = padded[-1] = 0
    padded[1:-1] = mask
    d = np.diff(padded)
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return (ends - starts) + 1


def cht_cost_model(spline_keys: np.ndarray, r_max: int, delta_max: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Algorithm 1. Returns (lambda[r, d], nodes[r, d], bytes[r, d]);
    row/col 0 are unused (r, delta >= 1)."""
    sk = np.asarray(spline_keys, dtype=np.uint64)
    n = sk.size
    lcp = adjacent_lcp(sk)
    lam = np.full((r_max + 1, delta_max + 1), np.inf)
    nodes = np.zeros((r_max + 1, delta_max + 1), dtype=np.int64)
    # window [q~, q~+delta] inclusive -> delta+1 candidate slots
    search = ceil_log2(np.arange(delta_max + 1, dtype=np.uint64) + 1)
    for r in range(1, r_max + 1):
        depth_acc = np.zeros(delta_max + 1, dtype=np.int64)
        node_acc = np.zeros(delta_max + 1, dtype=np.int64)
        p = r
        while p < 64:
            mask = lcp >= p
            if not mask.any():
                break
            m = _run_key_counts(mask)          # bin key-counts at this level
            idx = np.minimum(m - 1, delta_max)
            np.add.at(depth_acc, idx, m)       # bin splits iff m > delta
            np.add.at(node_acc, idx, 1)        # ... and then spawns one node
            p += r
        depth_suf = np.cumsum(depth_acc[::-1])[::-1]   # sum_{i >= d}
        node_suf = np.cumsum(node_acc[::-1])[::-1]
        d = np.arange(1, delta_max + 1)
        lam[r, 1:] = search[1:] + depth_suf[d] / n
        nodes[r, 1:] = 1 + node_suf[d]
    byts = nodes.astype(np.int64) * 4 * (np.uint64(1) << np.arange(
        r_max + 1, dtype=np.uint64))[:, None].astype(np.int64)
    return lam, nodes, byts


@dataclasses.dataclass
class TuneResult:
    kind: str                 # "radix" | "cht"
    r: int
    delta: int | None
    predicted_lambda: float
    predicted_bytes: int
    budget_bytes: int
    # full model grids kept for inspection/benchmarks
    radix_lambda: np.ndarray
    radix_bytes: np.ndarray
    cht_lambda: np.ndarray
    cht_bytes: np.ndarray
    cht_nodes: np.ndarray


def tune(spline: Spline, data_keys: np.ndarray, *,
         r_max_radix: int = 24, r_max_cht: int = 16, delta_max: int = 1024,
         budget_bytes: int | None = None, sample: int | None = None,
         rng: np.random.Generator | None = None) -> TuneResult:
    """Pick the best radix layer under ``bytes <= budget`` (paper §3 PLEX:
    the default budget is the spline size, so PLEX is at most 2x the spline)."""
    budget = spline.size_bytes if budget_bytes is None else budget_bytes
    dk = np.asarray(data_keys, dtype=np.uint64)
    if sample is not None and dk.size > sample:
        rng = rng or np.random.default_rng(0)
        dk = dk[rng.integers(0, dk.size, sample)]
    # no candidate with 4*2^r > budget is feasible — don't model them
    r_cap = max(int(np.log2(max(budget / 4, 2))), 1)
    r_lam, r_byt, r_hi = radix_cost_model(spline.keys, dk,
                                          min(r_max_radix, r_cap))
    c_lam, c_nodes, c_byt = cht_cost_model(spline.keys,
                                           min(r_max_cht, r_cap), delta_max)

    best = ("radix", 1, None, np.inf, 4 * 3)
    for r in range(1, r_hi + 1):
        if r_byt[r] <= budget and r_lam[r] < best[3]:
            best = ("radix", r, None, float(r_lam[r]), int(r_byt[r]))
    feasible = c_byt <= budget
    masked = np.where(feasible, c_lam, np.inf)
    r_c, d_c = np.unravel_index(np.argmin(masked), masked.shape)
    if masked[r_c, d_c] < best[3]:   # strict: ties fall back to radix table
        best = ("cht", int(r_c), int(d_c), float(masked[r_c, d_c]),
                int(c_byt[r_c, d_c]))
    return TuneResult(kind=best[0], r=best[1], delta=best[2],
                      predicted_lambda=best[3], predicted_bytes=best[4],
                      budget_bytes=budget,
                      radix_lambda=r_lam, radix_bytes=r_byt,
                      cht_lambda=c_lam, cht_bytes=c_byt, cht_nodes=c_nodes)
