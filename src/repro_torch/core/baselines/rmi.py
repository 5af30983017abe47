"""Two-layer Recursive Model Index (Kraska et al. 2018) baseline.

Linear root (CDF-linear over the key range) dispatching to ``n_models``
second-layer linear models fit by least squares on their key range, with
recorded per-model error bounds (the standard RMI-with-bounds configuration
that CDFShop tunes). Build is fully vectorised via grouped sums, and gives
the reference's arrays bit for bit.

Two departures from the reference's lookup (ROADMAP queue 3, R8 and R9),
both exact where the reference is right:

* the leaf model's input ``q - first_key`` is rounded once from the exact
  64-bit difference, as the build fits it. The reference converts each
  absolute key to float64 first; above 2^53 neighbouring keys collapse to
  one double and the prediction leaves the recorded error window (R8).
  Below 2^53 both give the same prediction bit for bit;
* the error bounds cover the model's own keys only, so the window of an
  absent key that the root sends to a leaf past its keys can miss the
  lower bound (R9); ``window_lower_bound`` answers such a lane by a binary
  search over the whole array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..spline import _diff_f64, _unique_first
from ._window import predicted_window, window_lower_bound


@dataclasses.dataclass
class RMI:
    keys: np.ndarray         # full (possibly duplicated) data
    min_key: np.uint64
    scale: float             # n_models / (max - min)
    slopes: np.ndarray       # float64 [M]
    intercepts: np.ndarray   # float64 [M]  (relative to leaf first key)
    first_keys: np.ndarray   # uint64  [M]  centering anchors
    err_lo: np.ndarray       # int32  [M]
    err_hi: np.ndarray       # int32  [M]
    name: str = "RMI"

    @property
    def n_models(self) -> int:
        return self.slopes.size

    @property
    def size_bytes(self) -> int:
        # slope + intercept + anchor + 2 error bounds per leaf model
        return self.n_models * (8 + 8 + 8 + 4 + 4)

    def _leaf(self, q: np.ndarray) -> np.ndarray:
        rel = np.where(q > self.min_key, q - self.min_key,
                       np.uint64(0)).astype(np.float64)
        return np.clip((rel * self.scale).astype(np.int64), 0,
                       self.n_models - 1)

    def predict(self, q: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        q = np.asarray(q, dtype=np.uint64)
        m = self._leaf(q)
        x = _diff_f64(q, self.first_keys[m])
        pred = self.slopes[m] * x + self.intercepts[m]
        return pred, self.err_lo[m], self.err_hi[m]

    def lookup(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        pred, elo, ehi = self.predict(q)
        n = self.keys.size
        lo, hi = predicted_window(pred, elo, ehi, n)
        return window_lower_bound(self.keys, q, lo, hi)

def build_rmi(keys: np.ndarray, n_models: int = 1 << 16) -> RMI:
    keys = np.asarray(keys, dtype=np.uint64)
    ukeys, upos = _unique_first(keys)
    lo_k, hi_k = ukeys[0], ukeys[-1]
    span = float(hi_k - lo_k) or 1.0
    scale = n_models / span
    rel = (ukeys - lo_k).astype(np.float64)
    leaf = np.clip((rel * scale).astype(np.int64), 0, n_models - 1)
    # leaf ranges are contiguous (root is monotone)
    starts = np.searchsorted(leaf, np.arange(n_models))
    first_keys = np.where(starts < ukeys.size,
                          ukeys[np.minimum(starts, ukeys.size - 1)],
                          np.uint64(0))
    # grouped least squares on (x = key - first_key, y = rank)
    x = (ukeys - first_keys[leaf]).astype(np.float64)
    y = upos.astype(np.float64)
    cnt = np.zeros(n_models)
    sx = np.zeros(n_models)
    sy = np.zeros(n_models)
    sxx = np.zeros(n_models)
    sxy = np.zeros(n_models)
    np.add.at(cnt, leaf, 1.0)
    np.add.at(sx, leaf, x)
    np.add.at(sy, leaf, y)
    np.add.at(sxx, leaf, x * x)
    np.add.at(sxy, leaf, x * y)
    denom = cnt * sxx - sx * sx
    safe = np.abs(denom) > 1e-12
    slope = np.where(safe, (cnt * sxy - sx * sy) / np.where(safe, denom, 1.0),
                     0.0)
    inter = np.where(cnt > 0, (sy - slope * sx) / np.maximum(cnt, 1.0), 0.0)
    # empty models inherit a constant prediction: the rank of the first key at
    # or after their range (so their error bound stays 0-ish)
    empty = cnt == 0
    if empty.any():
        nxt = np.minimum(starts, ukeys.size - 1)
        inter = np.where(empty, upos[nxt].astype(np.float64), inter)
    # exact per-model error bounds
    pred = slope[leaf] * x + inter[leaf]
    err = y - pred                       # >0: model under-predicts
    elo = np.zeros(n_models)
    ehi = np.zeros(n_models)
    np.maximum.at(ehi, leaf, err)        # need to search upward by ehi
    np.maximum.at(elo, leaf, -err)
    return RMI(keys=keys, min_key=lo_k, scale=scale, slopes=slope,
               intercepts=inter, first_keys=first_keys,
               err_lo=np.ceil(np.maximum(elo, 0)).astype(np.int32),
               err_hi=np.ceil(np.maximum(ehi, 0)).astype(np.int32))
