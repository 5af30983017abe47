"""Stand-in for SOSD's ``osm_cellids_200M_uint64``: hierarchically clustered
cell ids (coarse cells, fine cells within them, jittered points), the
distribution of ``repro_torch.data.sosd``'s ``osm``, drawn on the device.

Every key is below 2^63, so the signed order of the drawn int64 values is
their unsigned order.
"""
from __future__ import annotations

import torch

BIAS = -(1 << 63)          # xor with it flips the top bit: k ^ 2^63


def generate(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` sorted keys, biased (``k ^ 2^63``) in an int64 tensor on
    ``device``."""
    n_coarse = max(n // 10000, 8)
    coarse = torch.randint(0, 1 << 62, (n_coarse,), generator=gen,
                           device=device)
    keys = coarse[torch.randint(0, n_coarse, (n,), generator=gen,
                                device=device)]
    del coarse
    keys += torch.randint(0, 1 << 36, (n,), generator=gen, device=device)
    keys += torch.randint(0, 1 << 16, (n,), generator=gen, device=device)
    keys = torch.sort(keys).values
    return keys.bitwise_xor_(BIAS)
