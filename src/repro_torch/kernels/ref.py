"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes, rounding where the TPU kernel it
replaces rounds. On a CPU tensor the kernel wrappers run these; on the card
``chip_smoke.py`` holds each kernel against them. Shapes:

  x     : (N, M, K)   N packed adapters, M tokens each
  w     : (N, K, L)
  scale : (N,) f32 or None
  out   : (N, M, L)   out[n] = scale[n] * x[n] @ w[n]
"""
from __future__ import annotations

from typing import Optional

import torch


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(scale.shape[0], *([1] * (ndim - 1)))


def packed_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x: (N, ..., K); w: (N, K, L) -> (N, ..., L). f32 accumulation, the
    f32 scale, then one cast to ``x.dtype`` (``packed_matmul.py:41-42``)."""
    lead = x.shape[1:-1]
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    out = torch.bmm(x3, w.float())
    if scale is not None:
        out = out * _bcast(scale.float(), out.ndim)
    return out.to(x.dtype).reshape(x.shape[0], *lead, w.shape[-1])


def packed_lora_delta_ref(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """alpha_n * (x_n @ A_n) @ B_n, with xA rounded to ``x.dtype`` between
    the two grouped products (``ops.py:210-211``, ``ref.py:33``)."""
    xa = packed_matmul_ref(x, a)
    return packed_matmul_ref(xa, b, scale=alpha)


def fused_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n], rounded as the
    Pallas kernel ``_fused_kernel`` rounds (``fused.py:75-104``): the base
    and xA accumulate in f32, xA is never rounded, B is cast to f32, and y
    is cast to ``x.dtype`` once.

    x: (N, ..., K); w: (K, L); a: (N, K, r); b: (N, r, L); scale: (N,)."""
    lead = x.shape[1:-1]
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).float()
    base = x3 @ w.float()
    xa = torch.bmm(x3, a.float())
    delta = torch.bmm(xa, b.float())
    if scale is not None:
        delta = delta * _bcast(scale.float(), delta.ndim)
    y = (base + delta).to(x.dtype)
    return y.reshape(x.shape[0], *lead, w.shape[-1])
