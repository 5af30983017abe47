"""Rotary position embeddings, standard RoPE and Qwen2-VL's M-RoPE (the
port of ``repro.layers.rope``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2], float32."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def rope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """pos [B, S] int32 -> (cos, sin) [B, S, head_dim//2] float32."""
    ang = pos.float()[..., None] * rope_freqs(head_dim, theta, pos.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(pos3: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): pos3 [3, B, S] (t/h/w streams); ``sections``
    split head_dim//2 into per-stream bands. Text tokens carry equal
    streams, which reduces to plain RoPE."""
    assert sum(sections) == head_dim // 2
    freqs = rope_freqs(head_dim, theta, pos3.device)
    cos_parts, sin_parts = [], []
    start = 0
    for s, sec in zip(pos3, sections):
        ang = s.float()[..., None] * freqs[start:start + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, H, D] (or [B, S, D] shared); cos/sin [B, S, D//2]."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    if x.dim() == 4:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)
