"""Fused base+delta LoRA kernels: the port of the Pallas kernel
``repro/kernels/fused.py::fused_matmul`` (dense and quantized W) and of the
``custom_vjp`` around it.

``fused_matmul(x, w, a, b, scale)`` computes
``y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n]`` in one pass over x,
rounding as the Pallas kernel does (xA stays f32; one cast of y); ``w`` may
be a transposed view of a contiguous tensor, which the backward's
``dx = fused(g, W^T, B^T, A^T)`` passes. ``fused_matmul_q`` is the same
function on a quantized W (``kernels/quant.py``), dequantized inside the
kernel's K loop. On a CUDA tensor they launch ``csrc/fused.cu`` and
``csrc/fused_q.cu``; on a CPU tensor they run the plain versions in
``ref.py``. They never fall back: a CUDA input a kernel does not take
raises, and so does one that requires grad while grad mode is on (the
kernels build no graph).

``_FusedLora`` is the autograd Function around them: its backward is the
reference's ``_bwd`` (``fused.py:354-431``), with dx through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_matmul import (
    DTYPE_CODES,
    check_cuda,
    check_no_graph,
    check_operand,
    layout,
    scale_ptr,
)
from repro_torch.kernels.quant import dequantize

MAX_RANK = 128  # RMAX of csrc/fused.cuh
PATHS = ("split3", "wgmma")  # PATH_SPLIT3, PATH_WGMMA of csrc/fused.cuh
QUANT_MODES = {torch.int8: 0, torch.uint8: 1}  # the codes' dtype -> mode of csrc/fused_q.cu


def _check_lora(name, x, a, b, l):
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)} must be 3-D"
        )
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    n, m, k = x.shape
    r = a.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: rank {r} outside [1, {MAX_RANK}]")
    check_operand(x, "x", (n, m, k), x.dtype, x.device)
    check_operand(a, "a", (n, k, r), x.dtype, x.device)
    check_operand(b, "b", (n, r, l), x.dtype, x.device)
    return n, m, k, r


def _workspace(n_ws: int, device) -> Optional[torch.Tensor]:
    # f32 partial sums of the base and of xA (see csrc/fused.cuh)
    return torch.empty((n_ws,), dtype=torch.float32, device=device) if n_ws else None


def fused_matmul(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    scale: Optional[torch.Tensor] = None, *, backward: bool = False,
) -> torch.Tensor:
    """y[n] = x[n] @ w + scale[n] * (x[n] @ a[n]) @ b[n].

    x: (N, M, K); w: (K, L) shared, contiguous or a transposed view of a
    contiguous (L, K) tensor; a: (N, K, r); b: (N, r, L); scale: (N,) f32 or
    None; bf16 or f32, r <= 128. ``backward`` marks the backward's dx call:
    it is counted in ``fused_matmul.bwd_launches`` instead of
    ``fused_matmul.launches``."""
    if x.device.type == "cpu":
        return _ref.fused_matmul_ref(x, w, a, b, scale)
    check_cuda("fused_matmul", x)
    check_no_graph("fused_matmul", x, w, a, b, scale)
    if w.dim() != 2:
        raise ValueError(f"fused_matmul: w {tuple(w.shape)} must be 2-D")
    l = w.shape[1]
    n, m, k, r = _check_lora("fused_matmul", x, a, b, l)
    trans_w = layout(w, "w", (k, l), x.dtype, x.device)
    s = scale_ptr(scale, n, x.device)
    y = torch.empty((n, m, l), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("fused")
    code = DTYPE_CODES[x.dtype]
    ws = _workspace(
        lib.plora_fused_matmul_workspace(x.data_ptr(), w.data_ptr(), n, m, k, l, r, code), x.device
    )
    rc = lib.plora_fused_matmul(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), s, y.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        n, m, k, l, r, code, int(trans_w), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, rc, "fused_matmul")
    if backward:
        fused_matmul.bwd_launches += 1
    else:
        fused_matmul.launches += 1
    return y


fused_matmul.launches = 0
fused_matmul.bwd_launches = 0


def fused_matmul_q(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, a: torch.Tensor,
    b: torch.Tensor, scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y[n] = x[n] @ deq(W) + scale[n] * (x[n] @ a[n]) @ b[n], W given as
    int8 codes (K, L) + f32 scales (1, L), or nf4 codes (K/2, L) uint8 + f32
    block scales (K/blk, L); each W element is the f32 product code * scale
    cast once to x's dtype. Other operands as :func:`fused_matmul`."""
    if x.device.type == "cpu":
        return _ref.fused_matmul_q_ref(x, codes, scales, a, b, scale)
    check_cuda("fused_matmul_q", x)
    check_no_graph("fused_matmul_q", x, a, b, scale)
    if codes.dtype not in QUANT_MODES or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError(
            f"fused_matmul_q: codes {codes.dtype} {tuple(codes.shape)}, scales "
            f"{tuple(scales.shape)}: expected 2-D int8 or uint8 codes and 2-D scales"
        )
    mode = QUANT_MODES[codes.dtype]
    l = codes.shape[1]
    n, m, k, r = _check_lora("fused_matmul_q", x, a, b, l)
    n_blocks = 1 if mode == 0 else scales.shape[0]
    if mode == 1 and (k % 2 or n_blocks == 0 or k % n_blocks):
        raise ValueError(f"fused_matmul_q: K {k} and {n_blocks} nf4 scale blocks do not fit")
    blk = 0 if mode == 0 else k // n_blocks
    check_operand(codes, "codes", (k if mode == 0 else k // 2, l), codes.dtype, x.device)
    check_operand(scales, "scales", (n_blocks, l), torch.float32, x.device)
    s = scale_ptr(scale, n, x.device)
    y = torch.empty((n, m, l), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("fused_q")
    code = DTYPE_CODES[x.dtype]
    ws = _workspace(
        lib.plora_fused_matmul_q_workspace(
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(), n, m, k, l, r, code
        ),
        x.device,
    )
    rc = lib.plora_fused_matmul_q(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), a.data_ptr(), b.data_ptr(), s,
        y.data_ptr(), ws.data_ptr() if ws is not None else None,
        n, m, k, l, r, code, mode, blk, torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, rc, "fused_matmul_q")
    fused_matmul_q.launches += 1
    return y


fused_matmul_q.launches = 0


def fused_matmul_path(x: torch.Tensor, w: torch.Tensor, r: int) -> str:
    """Which path ``csrc/fused.cuh``'s plan gives :func:`fused_matmul` on
    these CUDA operands (x (N, M, K), w (K, L), rank r): "wgmma" or
    "split3". The plan reads only shapes, dtype and alignment."""
    check_cuda("fused_matmul_path", x)
    n, m, k = x.shape
    code = _build.load("fused").plora_fused_matmul_path(
        x.data_ptr(), w.data_ptr(), n, m, k, w.shape[1], r, DTYPE_CODES[x.dtype]
    )
    return PATHS[code]


def fused_matmul_q_path(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, r: int) -> str:
    """:func:`fused_matmul_path` for :func:`fused_matmul_q`: the same plan."""
    check_cuda("fused_matmul_q_path", x)
    n, m, k = x.shape
    code = _build.load("fused_q").plora_fused_matmul_q_path(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), n, m, k, codes.shape[1], r,
        DTYPE_CODES[x.dtype],
    )
    return PATHS[code]


def xa_rounded(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x @ A per adapter, f32 accumulation, one cast to x's dtype: the xA
    the backward uses (the reference's ``_xa``, ``fused.py:299-300``)."""
    return torch.bmm(x.float(), a.float()).to(x.dtype)


class _FusedLora(torch.autograd.Function):
    """``x @ W + alpha_n * (x_n @ A_n) @ B_n`` for 3-D x (N, M, d_in), with
    the reference's backward (``fused.py:354-431``).

    forward(x, w, a, b, alpha, wq, impl, remat): ``w`` the dense (d_in,
    d_out) weight, or None with ``wq`` the quantized ``{"codes",
    "scales"}`` dict; ``impl`` "fused_pallas" (the kernels) or
    "fused_plain" (their plain versions); ``remat`` "save" | "recompute".

    Backward: g_s = g * alpha; d(xA) = g_s @ B^T in f32, cast to x's dtype;
    dx = fused(g, W^T, B^T, A^T, alpha) through the fused kernel -- one
    fused cast, as on the Pallas path (the reference's XLA path sums two
    casts) -- on W dequantized once for a quantized base; xA recomputed
    and rounded to x's dtype, or saved under remat="save" on the plain
    path only (the Pallas path always recomputes); dA, dB by einsum in x's
    dtype; dW only when asked, never for a quantized base."""

    @staticmethod
    def forward(ctx, x, w, a, b, alpha, wq, impl, remat):
        plain = impl == "fused_plain"
        if wq is not None:
            fn = _ref.fused_matmul_q_ref if plain else fused_matmul_q
            y = fn(x, wq["codes"], wq["scales"], a, b, alpha)
        else:
            y = (_ref.fused_matmul_ref if plain else fused_matmul)(x, w, a, b, alpha)
        saved_xa = xa_rounded(x, a) if remat == "save" and plain else None
        ctx.save_for_backward(x, w, a, b, alpha, saved_xa)
        ctx.wq, ctx.impl = wq, impl
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, a, b, alpha, saved_xa = ctx.saved_tensors
        wd = dequantize(ctx.wq, x.dtype) if ctx.wq is not None else w.to(x.dtype)
        g = g.to(x.dtype).contiguous()
        g_s = g * alpha.to(g.dtype)[:, None, None]
        dxa = torch.bmm(g_s.float(), b.float().transpose(1, 2)).to(x.dtype)
        bt, at = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
        if ctx.impl == "fused_plain":
            dx = _ref.fused_matmul_ref(g, wd.t(), bt, at, alpha)
        else:
            dx = fused_matmul(g, wd.t(), bt, at, alpha, backward=True)
        xa = saved_xa if saved_xa is not None else xa_rounded(x, a)
        da = torch.einsum("nmk,nmr->nkr", x, dxa).to(a.dtype)
        db = torch.einsum("nmr,nml->nrl", xa, g_s).to(b.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("nmk,nml->kl", x, g).to(w.dtype)
        return dx, dw, da, db, None, None, None, None
