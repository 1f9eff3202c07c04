"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes, rounding where the TPU kernel it
replaces rounds. On a CPU tensor the kernel wrappers run these; on the card
``chip_smoke.py`` holds each kernel against them. Shapes:

  x     : (N, M, K)   N packed adapters, M tokens each
  w     : (N, K, L)
  scale : (N,) f32 or None
  out   : (N, M, L)   out[n] = scale[n] * x[n] @ w[n]

The backward uses of ``packed_matmul`` are the same grouped product on
transposed operands, so ``packed_matmul_ref`` is their plain version too;
``packed_lora_delta_bwd_ref`` spells out the four cases of the reference's
``ops.py:_bwd`` together.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.quant import dequantize


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


def packed_lora_delta_bwd_ref(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor
):
    """(dx, dA, dB) of alpha_n * (x_n @ A_n) @ B_n for 3-D x (N, T, d), as
    the reference's backward computes them (``ops.py:221-236``): g scaled by
    alpha in g's type, xA recomputed, then the four grouped cases."""
    g = g.to(x.dtype)
    g_s = g * _bcast(alpha, g.ndim).to(g.dtype)
    xa = packed_matmul_ref(x, a)
    db = packed_matmul_ref(xa.transpose(1, 2), g_s)  # case 1: (xA)^T g_s
    dxa = packed_matmul_ref(g_s, b.transpose(1, 2))  # case 2: g_s B^T
    da = packed_matmul_ref(x.transpose(1, 2), dxa)  # case 3: x^T d(xA)
    dx = packed_matmul_ref(dxa, a.transpose(1, 2))  # case 4: d(xA) A^T
    return dx, da, db


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


def fused_matmul_q_ref(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, a: torch.Tensor,
    b: torch.Tensor, scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``fused_matmul_ref`` on the dequantized weight, each element the f32
    product code * scale cast once to ``x.dtype``, as the Pallas kernel's
    ``_dequant_tile`` rounds (``fused.py:107-130``)."""
    w = dequantize({"codes": codes, "scales": scales}, x.dtype)
    return fused_matmul_ref(x, w, a, b, scale)
