"""Distribution-faithful synthetic stand-ins for the SOSD datasets.

The paper evaluates on four 200M-key 64-bit SOSD datasets. Each generator
below is a copy of ``repro.data.sosd``'s (the same ``(name, n, seed)`` gives
the same keys in both packages) and
reproduces the *structural property* that drives index behaviour:

* ``amzn`` — book-popularity data: smooth heavy-tailed CDF (lognormal
  mixture). Easy for splines, moderate for radix layers.
* ``face`` — Facebook user ids: a dense low region plus a sparse band of
  extreme outliers in the high bits. This is the documented RadixSpline
  failure mode (most radix-table prefixes are wasted on the outlier span) and
  the dataset where PLEX's tuner must pick CHT.
* ``osm`` — composite OpenStreetMap cell ids: hierarchically clustered,
  multi-scale structure that is "hard to learn" for model-based indexes but
  friendly to radix approaches.
* ``wiki`` — Wikipedia edit timestamps: near-arithmetic sequence *with
  duplicate keys* (the case plain CHT rejects and PLEX handles, paper §4).

Sizes are configurable; defaults keep CI fast. Generators are deterministic
given (name, n, seed).
"""
from __future__ import annotations

import numpy as np

DATASETS = ("amzn", "face", "osm", "wiki")


def _amzn(rng: np.random.Generator, n: int) -> np.ndarray:
    parts = []
    for mu, sigma, w in ((18.0, 1.2, 0.5), (21.0, 0.8, 0.3), (15.0, 2.0, 0.2)):
        m = int(n * w)
        parts.append(np.exp(rng.normal(mu, sigma, m)))
    x = np.concatenate(parts)[:n]
    while x.size < n:
        x = np.concatenate([x, np.exp(rng.normal(18.0, 1.2, n - x.size))])
    x = (x / x.max() * float(2**62)).astype(np.uint64)
    return np.sort(x)


def _face(rng: np.random.Generator, n: int) -> np.ndarray:
    # dense low region must itself be hard enough that the spline has many
    # points (clustered ids), so the outliers genuinely waste radix prefixes
    n_out = max(n // 1000, 4)                    # 0.1% extreme outliers
    n_dense = n - n_out
    n_cl = max(n_dense // 500, 8)
    centers = rng.integers(1 << 20, 1 << 40, n_cl, dtype=np.uint64)
    picks = centers[rng.integers(0, n_cl, n_dense)]
    jitter = rng.integers(0, 1 << 14, n_dense, dtype=np.uint64)
    dense = picks + jitter
    outl = rng.integers(1 << 58, 1 << 63, n_out, dtype=np.uint64)
    return np.sort(np.concatenate([dense, outl]))


def _osm(rng: np.random.Generator, n: int) -> np.ndarray:
    # hierarchical clusters: coarse cells -> fine cells -> points
    n_coarse = max(n // 10000, 8)
    coarse = rng.integers(0, 1 << 62, n_coarse, dtype=np.uint64)
    picks = coarse[rng.integers(0, n_coarse, n)]
    fine = rng.integers(0, 1 << 36, n, dtype=np.uint64)
    jitter = rng.integers(0, 1 << 16, n, dtype=np.uint64)
    return np.sort(picks + fine + jitter)


def _wiki(rng: np.random.Generator, n: int) -> np.ndarray:
    # edit timestamps: bursty arrivals, ~8% duplicate keys
    gaps = rng.geometric(0.35, n).astype(np.uint64) - np.uint64(1)
    base = np.uint64(1_600_000_000)
    return base + np.cumsum(gaps).astype(np.uint64)


def generate(name: str, n: int = 200_000, seed: int = 0) -> np.ndarray:
    """Sorted uint64 keys for dataset ``name`` (see module docstring).
    Seeding uses a *stable* hash — Python's ``hash()`` is salted per
    process, which would make datasets irreproducible across runs."""
    import zlib
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    if name == "amzn":
        return _amzn(rng, n)
    if name == "face":
        return _face(rng, n)
    if name == "osm":
        return _osm(rng, n)
    if name == "wiki":
        return _wiki(rng, n)
    raise KeyError(f"unknown dataset {name!r}; options: {DATASETS}")
