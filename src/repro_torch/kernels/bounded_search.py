"""K4: the eps-window data probe, plain PyTorch versions and CUDA kernel
wrapper (the port of ``repro.kernels.bounded_search``).

Per query: ``base + |{j < window : data[base + j] < q}|``, the first index
in ``[base, base + window]`` whose key is >= q — exact because the window
contains the lower bound (the eps guarantee) and the data is sorted. The
reference gathers a ``[B, W]`` window of data keys in XLA and hands it to its
kernel; here the kernel (``csrc/bounded_search.cu``) reads the data plane
itself, so nothing is gathered ahead.

The reference has two numerically identical forms
(``plex_segment_lookup.probe_lower_bound``): ``"count"`` sweeps the window,
``"bisect"`` runs ``bit_length(window)`` fixed bisect rounds over it.
``probe_lower_bound`` is both, as the reference writes them. The port's
``"bisect"`` form is the *summary probe*, ``summary_lower_bound``: it
bisects the window's samples in the data plane's ``KeySummary`` (every 8th
key; first every 64th where the summary has two levels), then counts the
keys below q in the one 8-key segment that the last sample below q starts.
Same answers, but a query reads one 64-byte segment of the data plane (two
with two levels) where the reference's bisect reads six or seven sectors.

``bounded_search`` dispatches on the query tensor's device: the plain
version (``bounded_search_plain``) for CPU tensors, the kernel for CUDA
tensors, never a fallback between them. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_params_size, device_ptr, load_library
from .keys import lt, take
from .planes import SUMMARY_STRIDE, KeySummary, build_summary, summary_levels

PROBE_MODES = ("count", "bisect")
# the bisect form reads one data segment a query where the count sweep reads
# all ``window`` keys (PERF.md has both timed on the card)
DEFAULT_PROBE = "bisect"

# kernel launches of ``bounded_search`` on CUDA tensors (plain integer; set
# to 0 before a run and read after it to see which path ran)
launches = 0


def probe_lower_bound(keys: torch.Tensor, q: torch.Tensor,
                      base: torch.Tensor, *, window: int, mode: str):
    """First index in ``[base, base + window]`` whose key is >= q
    (``base + window`` when every window key is < q), int64; the count and
    the bisect form give identical results."""
    if mode == "count":
        idx = base[:, None] + torch.arange(window, device=q.device)
        return base + lt(take(keys, idx), q[:, None]).sum(dim=1)
    lo = base
    hi = base + window - 1
    for _ in range(int(window).bit_length()):
        mid = (lo + hi) >> 1
        ge = ~lt(take(keys, mid), q)
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return lo


def _last_below(plane, q, lo, hi, trips: int):
    """Largest i in ``[lo, hi]`` with ``plane[i] < q``, else ``lo - 1``, by
    ``trips`` bisect rounds (enough for ``hi - lo + 1`` samples); only
    indices inside ``[lo, hi]`` are read."""
    a, b = lo - 1, hi
    for _ in range(trips):
        live = a < b
        mid = torch.where(live, (a + b + 1) >> 1, torch.zeros_like(a))
        go = live & lt(take(plane, mid), q)
        a = torch.where(go, mid, a)
        b = torch.where(live & ~go, mid - 1, b)
    return a


def _count_below(plane, q, lo, hi):
    """``#{j in [lo, hi) : plane[j] < q}`` for ranges of at most one
    segment (``SUMMARY_STRIDE`` entries); only indices inside are read."""
    offs = torch.arange(SUMMARY_STRIDE, device=q.device)
    idx = lo[:, None] + offs
    inside = idx < hi[:, None]
    keys = take(plane, torch.where(inside, idx, torch.zeros_like(idx)))
    return (inside & lt(keys, q[:, None])).sum(dim=1)


def summary_lower_bound(dk: torch.Tensor, summary: KeySummary,
                        q: torch.Tensor, base: torch.Tensor, *, window: int,
                        row: torch.Tensor | None = None) -> torch.Tensor:
    """The summary probe: first row-local index in ``[base, base +
    window]`` whose key is >= q, int64, as ``probe_lower_bound`` gives it.
    ``base`` is local to the query's data-plane row ``row`` (row 0 when
    ``None``); ``dk`` holds ``summary.row`` keys a row.

    1. the level-1 samples inside the window, indices ``ceil(base / 8)`` to
       ``floor((base + window - 1) / 8)``: the last one below q, ``k``, by
       bisect (two levels: the last level-2 sample below q first, then a
       count over the 8-sample segment of level 1 it starts);
    2. the keys below q in the window's part of the data segment ``[8k,
       8k + 8)`` (when no sample is below q, ``k`` is the sample before the
       window's first, and the segment ends at that first sample).
    The sample after ``k`` is >= q, so no other data key is needed."""
    s = SUMMARY_STRIDE
    zero = torch.zeros_like(q)
    row = zero if row is None else row
    last = base + window - 1
    i0 = (base + s - 1) // s
    i1 = last // s
    l1 = summary.l1
    r1 = row * summary.n1
    if summary.levels == 1:
        k1 = _last_below(l1, q, r1 + i0, r1 + i1,
                         int(-(-window // s)).bit_length()) - r1
    else:
        r2 = row * summary.n2
        c2 = (base + s * s - 1) // (s * s)
        k2 = _last_below(summary.l2, q, r2 + c2, r2 + last // (s * s),
                         int(-(-window // (s * s))).bit_length()) - r2
        lo = torch.maximum(k2 * s, i0)
        hi = torch.minimum(k2 * s + s, i1 + 1)
        k1 = lo - 1 + _count_below(l1, q, r1 + lo, r1 + hi)
    lo = torch.maximum(k1 * s, base)
    hi = torch.minimum(k1 * s + s, base + window)
    rd = row * summary.row
    return lo + _count_below(dk, q, rd + lo, rd + hi)


def bounded_search_plain(dk: torch.Tensor, q: torch.Tensor,
                         base: torch.Tensor, *, window: int, mode: str,
                         summary: KeySummary) -> torch.Tensor:
    """The kernel's plain version, int32: the count form as the reference
    writes it, the bisect form as the summary probe."""
    base = base.long()
    if mode == "count":
        return probe_lower_bound(dk, q, base, window=window,
                                 mode="count").int()
    return summary_lower_bound(dk, summary, q, base, window=window).int()


class _ProbeParams(ctypes.Structure):
    """Mirror of ``ProbeParams`` in ``csrc/bounded_search.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "dk", "s1", "s2", "q", "base", "out")] + [
        (name, ctypes.c_int64) for name in ("n_q", "n_row", "n1")] + [
        ("window", ctypes.c_int32)]


def _launch(dk, q, base, window: int, mode: str, summary: KeySummary
            ) -> torch.Tensor:
    """One kernel launch over ``q`` on the current stream (no sync, no
    allocation inside the kernel). The bases are not read back to check
    them: the segment lookup clips every base to ``[0, n_data - window]``."""
    global launches
    lib = load_library("bounded_search")
    check_params_size(lib, "bounded_search_params_size", _ProbeParams)
    dev = q.device
    if q.numel() >= (1 << 31):
        raise ValueError("a launch takes fewer than 2^31 queries")
    if base.shape != q.shape:
        raise ValueError("one base per query")
    n = q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    p = _ProbeParams()
    p.dk = device_ptr("data plane", dk, torch.int64, dev)
    p.s1 = device_ptr("summary level 1", summary.l1, torch.int64, dev)
    p.s2 = device_ptr("summary level 2", summary.l2, torch.int64, dev)
    p.q = device_ptr("queries", q, torch.int64, dev)
    p.base = device_ptr("base", base, torch.int32, dev)
    p.out = out.data_ptr()
    p.n_q = n
    p.n_row = summary.row
    p.n1 = summary.n1
    p.window = window
    # 0: the count sweep; 1, 2: the summary probe over that many levels
    form = summary.levels if mode == "bisect" else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.plex_bounded_search(ctypes.addressof(p), form, stream)
    check_launch(lib, "bounded_search_error_string", err, "bounded_search")
    launches += 1
    return out


def bounded_search(dk: torch.Tensor, q: torch.Tensor, base: torch.Tensor,
                   *, window: int, mode: str = DEFAULT_PROBE,
                   summary: KeySummary | None = None) -> torch.Tensor:
    """K4: int32 lower-bound index per biased query ``q`` given the int32
    base of its ``window``-wide eps window over the data plane ``dk``
    (``dk`` holds at least ``base + window`` keys). ``summary`` is ``dk``'s
    key summary (one row); without it one is made from ``dk`` here, by a
    strided copy on its device. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}")
    if window < 1 or window > dk.numel():
        raise ValueError(f"window {window} outside [1, {dk.numel()}]")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if summary is None:
        summary = build_summary(dk, dk.numel(), summary_levels(dk.numel()))
    elif summary.row != dk.numel():
        raise ValueError(f"summary of {summary.row}-key rows for a data "
                         f"plane of {dk.numel()} keys")
    if q.device.type == "cpu":
        return bounded_search_plain(dk, q, base, window=window, mode=mode,
                                    summary=summary)
    return _launch(dk, q, base, window, mode, summary)
