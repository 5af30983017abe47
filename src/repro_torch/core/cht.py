"""Compact Hist-Tree (CHT) — PLEX's multi-level radix layer.

Host build and host descent of the port, identical to ``repro.core.cht``
(same cells from the same spline keys). The device descends in
``repro_torch.kernels.stacked_lookup`` and ``segment_lookup``.

A pointer-free radix tree over the (unique, sorted) spline keys, built
*directly* from the key array level-by-level (the paper's contribution over
Crotty's HT->CHT bulk-load: keys are processed in contiguous chunks, no sparse
tree is materialised first).

Geometry (kept exactly consistent with the auto-tuner cost model in
``autotune.py`` — the paper's Eq. 2 / Algorithm 1):

* level ``l`` examines raw-key bits ``[l*r, (l+1)*r)`` counted from the MSB
  (no common-prefix stripping, matching the lcp-histogram model),
* a bin with ``count > delta`` keys becomes a child node; otherwise it is
  terminal and stores ``q~ = max(first_idx - 1, 0)`` where ``first_idx`` is the
  index of the first spline key >= the bin's lower boundary,
* the true predecessor index of any query landing in a terminal bin lies in
  ``[q~, q~ + delta]`` (inclusive; the +1 widening vs. the paper's
  ``{q~,...,q~+delta-1}`` covers the below-first-key-in-bin boundary case,
  a documented deviation).

Storage: a flat uint32 array, one node = ``2**r`` consecutive cells
(exactly the paper's "flat array, no pointers" layout). Cell encoding:
MSB set -> child node id in the low 31 bits; MSB clear -> terminal ``q~``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CHILD_FLAG = np.uint32(1 << 31)
VALUE_MASK = np.uint32((1 << 31) - 1)


def bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Exact vectorised bit_length for uint64 (no float round-trip)."""
    x = np.asarray(x, dtype=np.uint64)
    r = np.zeros(x.shape, dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= np.uint64(1 << s)
        r += np.where(big, s, 0)
        x = np.where(big, x >> np.uint64(s), x)
    return r + (x > 0)


def adjacent_lcp(keys: np.ndarray) -> np.ndarray:
    """lcp_i = common-prefix length of keys[i-1], keys[i] (the lcp-histogram)."""
    keys = np.asarray(keys, dtype=np.uint64)
    return (64 - bit_length_u64(keys[1:] ^ keys[:-1])).astype(np.int64)


def _extract_bins(keys: np.ndarray, offset: int, r: int) -> np.ndarray:
    """Bits [offset, offset+r) from the MSB, as int64 bin ids."""
    shifted = keys << np.uint64(offset) if offset else keys
    return (shifted >> np.uint64(64 - r)).astype(np.int64)


@dataclasses.dataclass
class CHT:
    r: int
    delta: int
    cells: np.ndarray        # uint32 [n_nodes * 2**r]
    n_nodes: int
    max_depth: int           # number of levels below the root (>=0)
    n_keys: int              # number of indexed (spline) keys

    @property
    def size_bytes(self) -> int:
        return 4 * self.cells.size

    def lookup(self, q: np.ndarray) -> np.ndarray:
        """q~ per query: true predecessor index in [q~, q~ + delta]."""
        q = np.asarray(q, dtype=np.uint64)
        fanout = 1 << self.r
        node = np.zeros(q.shape, dtype=np.int64)
        out = np.zeros(q.shape, dtype=np.int64)
        done = np.zeros(q.shape, dtype=bool)
        for level in range(self.max_depth + 1):
            bins = _extract_bins(q, level * self.r, self.r)
            cell = self.cells[node * fanout + bins]
            is_child = (cell & CHILD_FLAG) != 0
            val = (cell & VALUE_MASK).astype(np.int64)
            out = np.where(~done & ~is_child, val, out)
            done |= ~is_child
            node = np.where(is_child & ~done, val, node)
        return out


def build_cht(keys: np.ndarray, r: int, delta: int) -> CHT:
    """Direct chunked level-by-level build over sorted unique uint64 keys."""
    keys = np.asarray(keys, dtype=np.uint64)
    n = keys.size
    if n == 0:
        raise ValueError("empty key set")
    if not (1 <= r <= 30):
        raise ValueError("r out of range")
    if delta < 1:
        raise ValueError("delta must be >= 1")
    if np.any(keys[1:] <= keys[:-1]):
        raise ValueError("keys must be sorted and unique")

    fanout = 1 << r
    probes = np.arange(fanout + 1, dtype=np.int64)
    node_cells: list[np.ndarray] = []
    # Nodes at the current level: (global_start, global_end) contiguous ranges.
    current: list[tuple[int, int]] = [(0, n)]
    n_nodes = 0
    level = 0
    max_depth = 0
    while current:
        offset = level * r
        if offset >= 64:  # unique keys guarantee count<=1 long before this
            raise AssertionError("CHT descended past 64 bits")
        nxt: list[tuple[int, int]] = []
        # child ids are assigned level-ordered: nodes of the next level start
        # right after all nodes up to and including this level.
        base_next = n_nodes + len(current)
        for (s, e) in current:
            bins = _extract_bins(keys[s:e], offset, r)
            bounds = np.searchsorted(bins, probes)          # [fanout+1]
            counts = np.diff(bounds)
            first_global = np.where(bounds[:-1] < (e - s), s + bounds[:-1], e)
            qtilde = np.maximum(first_global - 1, 0).astype(np.uint32)
            cells = qtilde.copy()
            child = counts > delta
            if child.any():
                ids = base_next + len(nxt) + np.arange(int(child.sum()))
                cells[child] = (ids.astype(np.uint32) | CHILD_FLAG)
                for v in np.nonzero(child)[0]:
                    nxt.append((s + int(bounds[v]), s + int(bounds[v + 1])))
            node_cells.append(cells)
        n_nodes += len(current)
        if nxt:
            max_depth = level + 1
        current = nxt
        level += 1
    return CHT(r=r, delta=delta, cells=np.concatenate(node_cells),
               n_nodes=n_nodes, max_depth=max_depth, n_keys=n)
