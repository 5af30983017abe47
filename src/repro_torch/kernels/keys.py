"""u64 keys as one biased int64 plane — the port's key representation.

The reference carries u64 keys as (hi, lo) uint32 planes because a TPU has no
64-bit integers (``repro.kernels.pairs``). PyTorch on the CPU cannot compare,
subtract or shift ``uint32``/``uint64`` tensors, and on the card one 8-byte
load per key beats two 4-byte loads, so the port keeps each key as one
``int64`` holding ``k ^ 2^63`` (the *biased* key):

* signed order of biased keys is the unsigned order of the keys, so ``<`` and
  ``<=`` need nothing special;
* the exact 64-bit difference ``a - b (mod 2^64)`` of two keys is the int64
  difference of their biased forms, wrapping: the bias cancels;
* where the reference needs the hi/lo words of such a difference
  (``pair_to_f32``) they are split out with masks — an arithmetic shift of
  a negative int64 needs ``& 0xFFFFFFFF``; the radix prefix shifts the
  whole difference (``shr_sat``).

Host helpers take and give numpy arrays; the tensor helpers work on any
device and are what the plain PyTorch pipeline is written in.
"""
from __future__ import annotations

import numpy as np
import torch

_BIAS = np.uint64(1 << 63)
_LOW32 = 0xFFFFFFFF
# biased form of the largest u64 key: the pad of every key plane
MAX_BIASED = (1 << 63) - 1


def to_biased(x: np.ndarray) -> np.ndarray:
    """Host: uint64 keys -> biased int64 keys (order-preserving)."""
    return (np.asarray(x, dtype=np.uint64) ^ _BIAS).view(np.int64)


def from_biased(b: np.ndarray) -> np.ndarray:
    """Host: inverse of ``to_biased``."""
    return np.asarray(b, dtype=np.int64).view(np.uint64) ^ _BIAS


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a < b`` for biased keys (the u64 order)."""
    return a < b


def le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a <= b`` for biased keys (the u64 order)."""
    return a <= b


def diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a - b (mod 2^64)`` of two biased keys, as the int64 holding
    the u64 bit pattern (the bias cancels; int64 subtraction wraps)."""
    return a - b


def split_words(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a u64 bit pattern held in int64, each as a
    non-negative int64."""
    return (d >> 32) & _LOW32, d & _LOW32


def diff_to_f32(d: torch.Tensor) -> torch.Tensor:
    """float32 value of a u64 difference, rounded exactly as the reference's
    ``pair_to_f32``: ``f32(hi) * 2^32 + f32(lo)``. Each word rounds to f32,
    then the sum rounds again — this is *not* ``(float)u64``."""
    hi, lo = split_words(d)
    return hi.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def shr_sat(d: torch.Tensor, s, cap) -> torch.Tensor:
    """``min((u64) d >> s, cap)`` for a u64 bit pattern held in int64 and a
    shift ``0 <= s < 64`` (an int, or one per element): the whole shifted
    value, saturated, where the reference keeps its low 32 bits
    (``pair_shr_dyn``) and so wraps for a key far past the last one
    (ROADMAP queue 3, R5). Below 2^31 the two agree."""
    s = torch.as_tensor(s, device=d.device)
    cap = torch.as_tensor(cap, device=d.device)
    half = (d >> 1) & MAX_BIASED            # (u64) d >> 1, non-negative
    # for s == 0 the value is d itself, negative when it is >= 2^63
    v = torch.where(s > 0, half >> torch.clamp(s - 1, min=0), d)
    return torch.where(v < 0, cap, torch.minimum(v, cap))


def extract_bits(b: torch.Tensor, offset: int, r: int) -> torch.Tensor:
    """Bits ``[offset, offset + r)`` from the MSB of the *unbiased* key, as
    int64 (``(k << offset) >> (64 - r)``, the CHT bin geometry)."""
    k = b ^ torch.iinfo(torch.int64).min
    return ((k << offset) >> (64 - r)) & ((1 << r) - 1)


def take(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather that refuses out-of-bounds indices on the CPU. A torch index
    wraps negative values silently and a CUDA kernel would read whatever
    lies there, where ``jnp.take`` fills; so the plain versions check every
    gather they make in the tests."""
    if idx.device.type == "cpu" and idx.numel() and (
            int(idx.min()) < 0 or int(idx.max()) >= plane.numel()):
        raise IndexError(f"gather index out of [0, {plane.numel()}): "
                         f"[{int(idx.min())}, {int(idx.max())}]")
    return plane[idx]
