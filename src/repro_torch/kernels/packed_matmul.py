"""Grouped GEMM over packed LoRA adapters: the port of the Pallas kernel
``repro/kernels/packed_matmul.py::packed_matmul``.

``packed_matmul(x, w, scale)`` computes ``out[n] = scale[n] * (x[n] @ w[n])``
with f32 accumulation and one cast to ``x.dtype``. On a CUDA tensor it
launches the hand-written kernel ``csrc/packed_matmul.cu``; on a CPU tensor
it runs the plain version ``ref.packed_matmul_ref``. It never falls back:
a CUDA input the kernel does not take raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_matmul_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` has this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def scale_ptr(scale: Optional[torch.Tensor], n: int, device) -> Optional[int]:
    """The (N,) f32 scale operand's address, or None (a null pointer: the
    kernel then scales by 1, as the TPU kernel's scale of ones)."""
    if scale is None:
        return None
    check_operand(scale, "scale", (n,), torch.float32, device)
    return scale.data_ptr()


def packed_matmul(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """out[n] = scale[n] * (x[n] @ w[n]).

    x: (N, M, K); w: (N, K, L); scale: (N,) f32 or None; bf16 or f32."""
    if x.device.type == "cpu":
        return packed_matmul_ref(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"packed_matmul: x on {x.device}, not the current CUDA device")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"packed_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} must be 3-D")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"packed_matmul: dtype {x.dtype} not supported")
    n, m, k = x.shape
    l = w.shape[2]
    check_operand(x, "x", (n, m, k), x.dtype, x.device)
    check_operand(w, "w", (n, k, l), x.dtype, x.device)
    s = scale_ptr(scale, n, x.device)
    out = torch.empty((n, m, l), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("packed_matmul")
    n_ws = lib.plora_packed_matmul_workspace(n, m, k, l)
    # f32 partial sums of a split K loop (see csrc/tile.cuh)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device) if n_ws else None
    rc = lib.plora_packed_matmul(
        x.data_ptr(), w.data_ptr(), s, out.data_ptr(), ws.data_ptr() if ws is not None else None,
        n, m, k, l, DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, rc, "packed_matmul")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
