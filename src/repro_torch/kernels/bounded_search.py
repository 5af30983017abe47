"""K4: the eps-window data probe, plain PyTorch version and CUDA kernel
wrapper (the port of ``repro.kernels.bounded_search``).

Per query: ``base + |{j < window : data[base + j] < q}|``, the first index
in ``[base, base + window]`` whose key is >= q — exact because the window
contains the lower bound (the eps guarantee) and the data is sorted. The
reference gathers a ``[B, W]`` window of data keys in XLA and hands it to its
kernel; here the kernel (``csrc/bounded_search.cu``) reads the data plane at
``base + j`` itself, so nothing is gathered ahead.

``probe_lower_bound`` is the plain version in the reference's two
numerically identical forms (``plex_segment_lookup.probe_lower_bound``):
``"count"`` sweeps the window, ``"bisect"`` runs ``bit_length(window)``
fixed bisect rounds. ``bounded_search`` dispatches on the query tensor's
device: the plain version for CPU tensors, the kernel for CUDA tensors,
never a fallback between them. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_params_size, device_ptr, load_library
from .keys import lt, take

PROBE_MODES = ("count", "bisect")
# fixed-trip bisect reads bit_length(window) keys per query where the count
# sweep reads all ``window`` of them (PERF.md has both timed on the card)
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


class _ProbeParams(ctypes.Structure):
    """Mirror of ``ProbeParams`` in ``csrc/bounded_search.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "dk", "q", "base", "out")] + [("n_q", ctypes.c_int64)] + [
        (name, ctypes.c_int32) for name in ("window", "trips")]


def _launch(dk, q, base, window: int, mode: str) -> torch.Tensor:
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
    p.q = device_ptr("queries", q, torch.int64, dev)
    p.base = device_ptr("base", base, torch.int32, dev)
    p.out = out.data_ptr()
    p.n_q = n
    p.window = window
    p.trips = int(window).bit_length()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.plex_bounded_search(ctypes.addressof(p), int(mode == "bisect"),
                                  stream)
    check_launch(lib, "bounded_search_error_string", err, "bounded_search")
    launches += 1
    return out


def bounded_search(dk: torch.Tensor, q: torch.Tensor, base: torch.Tensor,
                   *, window: int, mode: str = DEFAULT_PROBE) -> torch.Tensor:
    """K4: int32 lower-bound index per biased query ``q`` given the int32
    base of its ``window``-wide eps window over the data plane ``dk``
    (``dk`` holds at least ``base + window`` keys). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}")
    if window < 1 or window > dk.numel():
        raise ValueError(f"window {window} outside [1, {dk.numel()}]")
    if q.device.type == "cpu":
        return probe_lower_bound(dk, q, base.long(), window=window,
                                 mode=mode).int()
    if q.device.type == "cuda":
        return _launch(dk, q, base, window, mode)
    raise ValueError(f"unsupported device {q.device}")
