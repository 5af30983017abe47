"""Device side of the port: key representation (``keys``), device planes
(``planes``), the kernels with their plain PyTorch versions — the fused
stacked lookup K1 (``stacked_lookup``), the single-index segment lookup K2/K3
(``segment_lookup``), the eps-window probe K4 (``bounded_search``) and the
LM's flash-attention forward K5 (``flash_attention``), CUDA sources in
``csrc/`` — the per-index pipeline ``DevicePlex`` (``ops``), dense
test oracles (``ref``) and the kernel build (``_build``). Kernels are
compiled and loaded at first launch, never at import. (K4's wrapper is
``bounded_search.bounded_search`` and K5's ``flash_attention.
flash_attention_fwd``; they are not re-exported here, where their names
would hide their modules.)"""
from .bounded_search import probe_lower_bound
from .ops import DevicePlex
from .planes import PlexPlanes, build_planes
from .segment_lookup import cht_segment_lookup, cht_window_base, \
    radix_segment_lookup, radix_window_base

__all__ = [
    "DevicePlex", "PlexPlanes", "build_planes", "cht_segment_lookup",
    "cht_window_base", "probe_lower_bound", "radix_segment_lookup",
    "radix_window_base",
]
