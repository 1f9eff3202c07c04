"""Rotary position embeddings (split-half convention)."""
from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """f32 cos/sin tables for integer ``positions`` (...,); dim even."""
    inv = 1.0 / (
        theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    )
    ang = positions.to(torch.float32)[..., None] * inv  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (first half, second half) of the last dim.

    x: (..., S, H, D). cos/sin: (S, D/2) shared across the batch, or
    (B, S, D/2) per row (decode at per-row positions). The product is
    taken in f32 (the tables' type) and cast back to ``x.dtype``."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos.unsqueeze(-2)  # (..., S, 1, D/2)
    s = sin.unsqueeze(-2)
    while c.dim() < x1.dim():
        c, s = c[None], s[None]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
