"""Fused base+delta LoRA kernel: the port of the dense branch of the Pallas
kernel ``repro/kernels/fused.py::fused_matmul``, forward only.

``fused_matmul(x, w, a, b, scale)`` computes
``y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n]`` in one pass over x,
rounding as the Pallas kernel does (xA stays f32; one cast of y). On a CUDA
tensor it launches ``csrc/fused.cu``; on a CPU tensor it runs the plain
version ``ref.fused_matmul_ref``. It never falls back: a CUDA input the
kernel does not take raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed_matmul import DTYPE_CODES, check_operand, scale_ptr
from repro_torch.kernels.ref import fused_matmul_ref

MAX_RANK = 128  # RMAX of csrc/fused.cu


def fused_matmul(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y[n] = x[n] @ w + scale[n] * (x[n] @ a[n]) @ b[n].

    x: (N, M, K); w: (K, L) shared; a: (N, K, r); b: (N, r, L);
    scale: (N,) f32 or None; bf16 or f32, r <= 128."""
    if x.device.type == "cpu":
        return fused_matmul_ref(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"fused_matmul: x on {x.device}, not the current CUDA device")
    if x.dim() != 3 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(
            f"fused_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}: expected 3-D, 2-D, 3-D, 3-D"
        )
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_matmul: dtype {x.dtype} not supported")
    n, m, k = x.shape
    l = w.shape[1]
    r = a.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"fused_matmul: rank {r} outside [1, {MAX_RANK}]")
    check_operand(x, "x", (n, m, k), x.dtype, x.device)
    check_operand(w, "w", (k, l), x.dtype, x.device)
    check_operand(a, "a", (n, k, r), x.dtype, x.device)
    check_operand(b, "b", (n, r, l), x.dtype, x.device)
    s = scale_ptr(scale, n, x.device)
    y = torch.empty((n, m, l), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("fused")
    code = DTYPE_CODES[x.dtype]
    n_ws = lib.plora_fused_matmul_workspace(x.data_ptr(), w.data_ptr(), n, m, k, l, r, code)
    # f32 partial sums of the base and of xA (see csrc/fused.cu)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device) if n_ws else None
    rc = lib.plora_fused_matmul(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), s, y.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        n, m, k, l, r, code, torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, rc, "fused_matmul")
    fused_matmul.launches += 1
    return y


fused_matmul.launches = 0
