"""``DevicePlex``: the per-index device lookup (the port of
``repro.kernels.ops``).

``DevicePlex.from_plex`` converts a host-built ``PLEX`` into ``PlexPlanes``
on the device; ``DevicePlex.lookup`` runs the batched pipeline

    pad to a block multiple -> bias -> one upload ->
    K2 or K3 (``segment_lookup``: window bases) ->
    K4 (``bounded_search``: the eps-window probe) -> finalize

where K2/K3 and K4 run as one launch per call on a CUDA device, whatever
the batch size (``segment_lookup.window_probe``: K4's summary probe on the
window base in registers; measured faster than the two launches on every
dataset, PERF.md). The reference gathers the ``[B, W]`` data windows in XLA
between its two kernels; here the probe reads the data plane itself,
through the planes' key summary. The reference's deprecated
``lookup_planes`` shim is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.plex import PLEX
from ..device import resolve_device
from .keys import to_biased
from .planes import PlexPlanes, build_planes, finalize_indices, pad_queries
from .segment_lookup import window_probe, window_probe_plain

DEFAULT_BLOCK = 512


@dataclasses.dataclass
class DevicePlex:
    """One PLEX on one device: its planes and the batch block. The probe
    runs in its summary form (``bounded_search``'s ``"bisect"``). ``plain``:
    every lookup runs ``window_probe_plain``, on the card too (the
    registry's ``torch`` backend)."""
    planes: PlexPlanes
    block: int
    plain: bool = False

    @classmethod
    def from_plex(cls, px: PLEX, *, block: int = DEFAULT_BLOCK,
                  device=None, plain: bool = False) -> "DevicePlex":
        """Planes of ``px`` on ``device`` (default: the CUDA card)."""
        if block % 128 != 0 or block <= 0:
            raise ValueError("block must be a positive multiple of 128")
        return cls(planes=build_planes(px, resolve_device(device)),
                   block=int(block), plain=bool(plain))

    def lookup(self, q: np.ndarray) -> np.ndarray:
        """Batched device lookup; same contract as ``PLEX.lookup`` for
        present keys (first occurrence), lower bound for absent ones."""
        q = np.asarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        pp = self.planes
        qp, b = pad_queries(q, self.block)
        qd = torch.from_numpy(to_biased(qp)).to(pp.device)
        probe = window_probe_plain if self.plain else window_probe
        return finalize_indices(probe(pp, qd), b, pp.n_real)
