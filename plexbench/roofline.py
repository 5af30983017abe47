"""The least bytes a batch of lookups has to move, and the card's peaks.

A lookup's work is counted from its inputs and its answer only, never from
an index's layers, so any kernel that answers the same queries is judged on
the same work:

* each query's 8-byte key, read once;
* its rank, written once: 4 bytes while the key array has fewer than 2^32
  keys (the least that holds it), else 8;
* each distinct 32-byte sector of the sorted key array that holds a key an
  answer rests on (the keys at ranks ``r - 1`` and ``r``: the last key
  below the query and the first at or above it), counted once in each
  batch (a request) and summed over the batches: no cache holds a sector
  from one request to the next, so the count grows with the work, whatever
  the rate at which the requests come.

A spline, a radix table or a summary is left out: the count errs low.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"
SECTOR_BYTES = 32
KEY_BYTES = 8
BIAS = np.uint64(1 << 63)


def peak(kind: str, what: str) -> float | None:
    """The data sheet's ``what`` of the card named ``kind`` (``None`` for a
    card the table lacks)."""
    return json.loads(PEAKS.read_text()).get(kind, {}).get(what)


def _biased(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy((a ^ BIAS).view(np.int64)).to(device)


def lookup_bytes(keys: np.ndarray, batches, device) -> int:
    """Least bytes of answering every query of ``batches`` (uint64 arrays,
    one a request) over the sorted uint64 ``keys``; worked out on
    ``device``."""
    n = keys.size
    kd = _biased(keys, device)
    per_key = SECTOR_BYTES // KEY_BYTES
    rank_bytes = 4 if n < 1 << 32 else 8
    n_q = sectors = 0
    for q in batches:
        r = torch.searchsorted(kd, _biased(np.ascontiguousarray(q), device))
        below = (r - 1).clamp_(0, n - 1) // per_key
        sectors += torch.unique(torch.cat([below, r.clamp_(max=n - 1)
                                           // per_key])).numel()
        n_q += q.size
    return n_q * (KEY_BYTES + rank_bytes) + SECTOR_BYTES * sectors
