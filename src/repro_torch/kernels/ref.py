"""Dense oracles for the port's kernels (the port of ``repro.kernels.ref``).

Each recomputes a kernel's contract with the simplest dense torch ops on
biased int64 keys and float32 ranks: predecessor and lower bound by a full
compare-and-count over the *whole* plane (O(S) per query, fine at test
sizes), so they share no windowing or searching logic with the kernels they
check. The tests use them; no lookup path does.
"""
from __future__ import annotations

import torch

from .keys import diff, diff_to_f32, le, lt


def segment_ref(q: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """Predecessor spline segment via dense count over all spline keys."""
    cnt = le(sk[None, :], q[:, None]).sum(dim=1)
    return torch.clamp(torch.clamp(cnt - 1, min=0), max=sk.numel() - 2)


def interp_ref(q, sk, spos, seg) -> torch.Tensor:
    """float32 interpolation at ``seg``. As the reference's oracle, the
    query-side difference is not snapped for ``q < x0`` (it wraps, so
    ``t`` clips to 1): hold kernels to it on queries >= the first key."""
    x0, x1 = sk[seg], sk[seg + 1]
    y0, y1 = spos[seg], spos[seg + 1]
    dx = torch.clamp(diff_to_f32(diff(x1, x0)), min=1.0)
    t = torch.clamp(diff_to_f32(diff(q, x0)) / dx, 0.0, 1.0)
    return y0 + t * (y1 - y0)


def window_base_ref(q, sk, spos, *, eps_eff: int, n_data: int,
                    window: int) -> torch.Tensor:
    """Oracle for the segment-lookup kernels' output (int32 bases)."""
    seg = segment_ref(q, sk)
    pred = interp_ref(q, sk, spos, seg)
    base = torch.floor(pred).long() - eps_eff
    return torch.clamp(base, 0, n_data - window).int()


def lower_bound_ref(q: torch.Tensor, dk: torch.Tensor) -> torch.Tensor:
    """Dense lower bound over the whole data plane (oracle for
    ``bounded_search``: it must equal this when the window holds the
    answer)."""
    return lt(dk[None, :], q[:, None]).sum(dim=1).int()
