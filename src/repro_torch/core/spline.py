"""Error-bounded linear spline over a sorted key array (PLEX's bottom layer).

Host build of the port, kept bit-identical to ``repro.core.spline`` so both
packages produce the same spline points from the same keys. The float64
interpolation of ``_interp_f64`` is a *build* detail (the repair pass, kept
as the reference has it). The host lookup (``Spline.predict``) takes the
exact 64-bit key difference before it converts to float64, where the
reference converts each absolute key first (above 2^53 neighbouring keys
collapse to one double, ROADMAP queue 3, R1): below 2^53 both give the same
prediction bit for bit. The device interpolates in float32 on the same exact
difference (``repro_torch.kernels.segment_lookup``).

Faithful to the paper: the spline is a subset of CDF points (key, rank) chosen
greedily in one pass (Neumann & Michel's corridor algorithm, the same one
RadixSpline uses) such that linear interpolation between consecutive spline
points predicts the rank of every key within ``eps`` positions.

Implementation notes:

* Keys are uint64 (SOSD convention).  Corridor slopes are evaluated in
  ``np.longdouble`` (80-bit x87 on x86-64, 64-bit mantissa) which represents
  every uint64 exactly; products are avoided in favour of slope comparisons.
* A final *verification and repair* pass checks the paper's invariant
  |p~ - p*| <= eps under float64 arithmetic and inserts extra spline points
  at any violation (the greedy pass alone can be off by one ULP-induced
  position on adversarial 64-bit keys); it is kept exactly as the reference
  has it, so the spline points stay identical.  The repair pass is vectorised and converges in <= 2 rounds on
  all tested distributions; it typically inserts zero points.
* The greedy scan is vectorised in chunks: from the current corridor base we
  evaluate candidate corridor slopes for a whole chunk with
  ``np.minimum.accumulate`` and find the first violation, which touches every
  CDF point at most twice (once per segment it terminates).  Chunks grow
  geometrically between emissions so spline-dense regions do not pay O(chunk)
  per point.
* Duplicate keys: the spline is built on unique keys with the rank of their
  *first* occurrence, exactly as in the paper (lookups return the first
  occurrence; this is also why PLEX handles the ``wiki`` dataset while plain
  CHT does not).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_LD = np.longdouble


def _unique_first(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique keys + rank of first occurrence. ``keys`` must be sorted."""
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size == 0:
        return keys, np.zeros(0, dtype=np.int64)
    mask = np.empty(keys.size, dtype=bool)
    mask[0] = True
    np.not_equal(keys[1:], keys[:-1], out=mask[1:])
    pos = np.nonzero(mask)[0].astype(np.int64)
    return keys[mask], pos


def _greedy_indices(ukeys: np.ndarray, upos: np.ndarray, eps: float) -> np.ndarray:
    """Indices (into the unique-key arrays) of greedy corridor spline points."""
    n = ukeys.size
    if n <= 2:
        return np.arange(n, dtype=np.int64)
    kx = ukeys.astype(_LD)
    ky = upos.astype(_LD)
    eps_ld = _LD(eps)

    out = [0]
    b = 0                      # corridor base (index of last spline point)
    hi = _LD(np.inf)           # current corridor slope bounds from base
    lo = _LD(-np.inf)
    i0 = b + 1                 # next unexamined point
    chunk = 64
    while i0 < n:
        j1 = min(i0 + chunk, n)
        dx = kx[i0:j1] - kx[b]
        dy = ky[i0:j1] - ky[b]
        s = dy / dx
        s_hi = (dy + eps_ld) / dx
        s_lo = (dy - eps_ld) / dx
        # Corridor bounds *before* each point narrows it.
        hi_run = np.minimum.accumulate(s_hi)
        lo_run = np.maximum.accumulate(s_lo)
        hi_before = np.empty_like(hi_run)
        lo_before = np.empty_like(lo_run)
        hi_before[0] = hi
        lo_before[0] = lo
        np.minimum(hi_run[:-1], hi, out=hi_before[1:])
        np.maximum(lo_run[:-1], lo, out=lo_before[1:])
        viol = (s > hi_before) | (s < lo_before)
        idx = np.nonzero(viol)[0]
        if idx.size:
            v = int(idx[0])
            # Emit the point *before* the violator as a new spline point and
            # restart the corridor from it; the violator is re-examined.
            b = i0 + v - 1
            out.append(b)
            hi = _LD(np.inf)
            lo = _LD(-np.inf)
            i0 = b + 1
            chunk = 64
        else:
            hi = min(hi, _LD(hi_run[-1]))
            lo = max(lo, _LD(lo_run[-1]))
            i0 = j1
            chunk = min(chunk * 2, 16384)
    if out[-1] != n - 1:
        out.append(n - 1)
    return np.asarray(out, dtype=np.int64)


def _interp_f64(sk: np.ndarray, sp: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Float64 spline interpolation of the repair pass (build only)."""
    seg = np.clip(np.searchsorted(sk, q, side="right") - 1, 0, sk.size - 2)
    x0 = sk[seg].astype(np.float64)
    x1 = sk[seg + 1].astype(np.float64)
    y0 = sp[seg].astype(np.float64)
    y1 = sp[seg + 1].astype(np.float64)
    qf = q.astype(np.float64)
    t = np.where(x1 > x0, (qf - x0) / np.maximum(x1 - x0, 1.0), 0.0)
    return y0 + t * (y1 - y0)


@dataclasses.dataclass
class Spline:
    """An eps-bounded linear spline: ``|predict(k) - rank(k)| <= eps``."""

    keys: np.ndarray      # uint64 [S] spline-point keys (subset of data keys)
    positions: np.ndarray # int64  [S] spline-point ranks
    eps: int
    n_keys: int           # number of indexed (non-unique) data keys

    @property
    def size_bytes(self) -> int:
        # 16 B per spline point (u64 key + 8 B position), paper convention.
        return 16 * self.keys.size

    def segment_of(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        return np.clip(np.searchsorted(self.keys, q, side="right") - 1,
                       0, self.keys.size - 2)

    def predict(self, q: np.ndarray) -> np.ndarray:
        """Approximate rank: |predict - rank of first occurrence| <= eps."""
        q = np.asarray(q, dtype=np.uint64)
        return self.predict_in_segment(q, self.segment_of(q))

    def predict_in_segment(self, q: np.ndarray,
                           seg: np.ndarray) -> np.ndarray:
        """float64 interpolation on segment ``seg``; unclipped, so a query
        outside the segment extrapolates, as in the reference."""
        q = np.asarray(q, dtype=np.uint64)
        x0 = self.keys[seg]
        x1 = self.keys[seg + 1]
        y0 = self.positions[seg].astype(np.float64)
        y1 = self.positions[seg + 1].astype(np.float64)
        dx = _diff_f64(x1, x0)
        t = np.where(x1 > x0, _diff_f64(q, x0) / np.maximum(dx, 1.0), 0.0)
        return y0 + t * (y1 - y0)


def _diff_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a - b`` of uint64 keys as float64, rounded once from the exact
    64-bit difference (signed: ``a < b`` gives a negative value)."""
    return np.where(a >= b, (a - b).astype(np.float64),
                    -(b - a).astype(np.float64))


def build_spline(keys: np.ndarray, eps: int) -> Spline:
    """Greedy corridor build + float64 verification/repair (see module doc)."""
    if eps < 1:
        raise ValueError("eps must be >= 1")
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size == 0:
        raise ValueError("cannot index an empty key set")
    if np.any(keys[1:] < keys[:-1]):
        raise ValueError("keys must be sorted")
    ukeys, upos = _unique_first(keys)
    sel = _greedy_indices(ukeys, upos, float(eps))
    sk, sp = ukeys[sel], upos[sel]

    # Verification/repair: enforce the paper's bound under float64 arithmetic.
    for _ in range(8):
        pred = _interp_f64(sk, sp, ukeys)
        bad = np.abs(pred - upos.astype(np.float64)) > eps
        if not bad.any():
            break
        extra = np.nonzero(bad)[0]
        take = np.union1d(np.searchsorted(ukeys, sk), extra)
        sk, sp = ukeys[take], upos[take]
    else:  # pragma: no cover - repair always converges (every point selected)
        sk, sp = ukeys, upos
    return Spline(keys=sk, positions=sp, eps=int(eps), n_keys=int(keys.size))
