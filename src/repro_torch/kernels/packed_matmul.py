"""Grouped GEMM over packed LoRA adapters: the port of the Pallas kernel
``repro/kernels/packed_matmul.py::packed_matmul``.

``packed_matmul(x, w, scale)`` computes ``out[n] = scale[n] * (x[n] @ w[n])``
with f32 accumulation and one cast to ``x.dtype``. On a CUDA tensor it
launches the hand-written kernel ``csrc/packed_matmul.cu``; on a CPU tensor
it runs the plain version ``ref.packed_matmul_ref``. It never falls back:
a CUDA input the kernel does not take raises.

x and w may each be a transposed view of a contiguous tensor (``t.transpose(1,
2)``, as the backward's four cases pass them): the kernel reads it in place.
The wrapper builds no autograd graph, so on CUDA it refuses inputs that
require grad while grad mode is on; ``kernels/ops.py``'s autograd Functions
call it from their forward and backward, where grad mode is off.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_matmul_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` has this shape, dtype and device and is contiguous."""
    if layout(t, name, shape, dtype, device):
        raise ValueError(f"{name}: must be contiguous")


def layout(t: torch.Tensor, name: str, shape, dtype, device) -> bool:
    """Check ``t``'s shape, dtype and device; return False when it is
    contiguous and True when it is the transpose of its last two dims of a
    contiguous tensor (the kernels read both in place); raise otherwise."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.is_contiguous():
        return False
    if t.transpose(-1, -2).is_contiguous():
        return True
    raise ValueError(f"{name}: must be contiguous (or the transpose of a contiguous tensor)")


def check_no_graph(name: str, *ts) -> None:
    """The kernels' outputs carry no autograd graph: refuse inputs that
    require grad while grad mode is on, rather than return an output the
    loss would silently not reach through."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad and grad mode is on, but the kernel's output "
            "carries no graph; call it through repro_torch.kernels.ops (its autograd "
            "Functions) or under torch.no_grad()"
        )


def check_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x on {x.device}, not the current CUDA device")


def scale_ptr(scale: Optional[torch.Tensor], n: int, device) -> Optional[int]:
    """The (N,) f32 scale operand's address, or None (a null pointer: the
    kernel then scales by 1, as the TPU kernel's scale of ones)."""
    if scale is None:
        return None
    check_operand(scale, "scale", (n,), torch.float32, device)
    return scale.data_ptr()


def packed_matmul(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
    backward: bool = False,
) -> torch.Tensor:
    """out[n] = scale[n] * (x[n] @ w[n]).

    x: (N, M, K); w: (N, K, L), each contiguous or a transposed view of a
    contiguous tensor; scale: (N,) f32 or None; bf16 or f32. ``backward``
    marks a launch for a backward case: it is counted in
    ``packed_matmul.bwd_launches`` instead of ``packed_matmul.launches``."""
    if x.device.type == "cpu":
        return packed_matmul_ref(x, w, scale)
    check_cuda("packed_matmul", x)
    check_no_graph("packed_matmul", x, w, scale)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"packed_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} must be 3-D")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"packed_matmul: dtype {x.dtype} not supported")
    n, m, k = x.shape
    l = w.shape[2]
    trans_x = layout(x, "x", (n, m, k), x.dtype, x.device)
    trans_w = layout(w, "w", (n, k, l), x.dtype, x.device)
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
        n, m, k, l, DTYPE_CODES[x.dtype], int(trans_x), int(trans_w),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, rc, "packed_matmul")
    if backward:
        packed_matmul.bwd_launches += 1
    else:
        packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
packed_matmul.bwd_launches = 0
