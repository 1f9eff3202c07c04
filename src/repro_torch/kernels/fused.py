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

A call takes one of four paths of ``csrc/fused.cuh``'s plan, which reads
only shapes, dtype, W's layout and alignment (``fused_matmul_path`` names
it): "decode" (bf16, at most 16 rows in all: the weight-streaming kernel of
``csrc/decode.cuh``), "wgmma" (bf16, more rows: the warp-specialised
tensor-core kernel, its row tiles per adapter in a pack whose rows per
adapter are no multiple of 64), "ffma" (f32, more than 16 rows, K and L
multiples of 4, operands on 16 bytes, W row-major or W^T: the tiled FFMA
kernel of ``csrc/ffma.cuh``) or "split3" (f32 and the backward's bf16 W^T
at decode rows, odd shapes). The plan is asked once per shape and cached, and a
launch is one ctypes call whose arguments go as one packed block. The
decode path's one workspace, xA (rows x r f32), lies behind y in y's own
allocation. Each wrapper counts its launches by direction and path.

A caller may ask the "wgmma" and "ffma" paths for another count of K
ranges than their plan's (``blocks=[k_splits]``, clamped as the plan
clamps): the choice the autotuner sweeps (``kernels/autotune.py``).
``blocks=None`` leaves every plan as it is.

``_FusedLora`` is the autograd Function around them: its backward is the
reference's ``_bwd`` (``fused.py:354-431``), with dx through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packed_matmul import (
    DTYPE_CODES,
    _device,
    _transposed,
    check_no_graph,
    check_operand,
    layout,
    scale_ptr,
)
from repro_torch.kernels.quant import dequantize

MAX_RANK = 128  # RMAX of csrc/fused.cuh
# PATH_SPLIT3, PATH_WGMMA, PATH_DECODE, PATH_FFMA of csrc/fused.cuh: "split3"
# three FMA launches (f32 at decode rows, odd shapes), "wgmma" the
# warp-specialised tensor-core kernel (bf16, more than 16 rows), "decode" the
# weight-streaming kernel of csrc/decode.cuh (bf16, at most 16 rows in all),
# "ffma" the tiled FFMA kernel of csrc/ffma.cuh (f32, more than 16 rows)
PATHS = ("split3", "wgmma", "decode", "ffma")
DECODE = PATHS.index("decode")
QUANT_MODES = {torch.int8: 0, torch.uint8: 1}  # the codes' dtype -> mode of csrc/fused_q.cu
# each launch's one argument: a block of 16 (dense) or 18 (quantized) int64
_ARGS = struct.Struct("<16q")
_ARGS_Q = struct.Struct("<18q")


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


def _scale(scale: Optional[torch.Tensor], n: int, dev: int) -> int:
    """The (N,) f32 scale's address, or 0 (no scale: the kernel scales by 1)."""
    if scale is None:
        return 0
    if (scale.dtype != torch.float32 or scale.shape != (n,) or scale.get_device() != dev
            or not scale.is_contiguous()):
        return scale_ptr(scale, n, torch.device("cuda", dev))  # raises, saying why
    return scale.data_ptr()


def _aligned16(*ts) -> bool:
    addr = 0
    for t in ts:
        addr |= t.data_ptr()
    return addr % 16 == 0


def _q_aligned(x, codes, scales) -> bool:
    """x and the scales on 16 bytes, the codes on 8: the quantized kernels' loads."""
    return (x.data_ptr() | scales.data_ptr()) % 16 == 0 and codes.data_ptr() % 8 == 0


def k_splits(blocks) -> int:
    """The K ranges a ``blocks`` override asks of the plan: ``[k_splits]``
    (the autotuner's candidate), or 0 for None (the plan's own choice)."""
    if blocks is None:
        return 0
    if len(blocks) != 1 or int(blocks[0]) < 1:
        raise ValueError(f"blocks {blocks!r}: expected None or [k_splits >= 1]")
    return int(blocks[0])


@functools.lru_cache(maxsize=None)
def _plan_info(lib_name: str, n: int, m: int, k: int, l: int, r: int, code: int, aligned: int,
               ab_aligned: int, trans_w: int = 0, splits: int = 0):
    """(path, f32 workspace elements, K ranges of the base product) of a
    call, from ``csrc/fused.cuh``'s plan -- the one the launch makes from
    the pointers. It reads only these sizes, the dtype, three flags
    (``aligned``: x and W can be read by the kernels' TMA and vector loads;
    ``ab_aligned``: A and B are 16-byte aligned; ``trans_w``: W is a
    transposed view, read in place) and the K ranges asked for (``splits``,
    0: the plan's choice), so it is asked once per shape."""
    ws, ks = ctypes.c_longlong(0), ctypes.c_int(0)
    if lib_name == "fused":
        path = _build.load("fused").plora_fused_matmul_plan(
            n, m, k, l, r, code, aligned, ab_aligned, trans_w, splits, ctypes.byref(ws),
            ctypes.byref(ks))
    else:
        path = _build.load("fused_q").plora_fused_matmul_q_plan(
            n, m, k, l, r, code, aligned, ab_aligned, splits, ctypes.byref(ws), ctypes.byref(ks))
    return path, ws.value, ks.value


def _plan(lib_name: str, n: int, m: int, k: int, l: int, r: int, code: int, aligned: int,
          ab_aligned: int, trans_w: int = 0, splits: int = 0):
    """(path, f32 workspace elements) of a call (:func:`_plan_info`)."""
    return _plan_info(lib_name, n, m, k, l, r, code, aligned, ab_aligned, trans_w, splits)[:2]


def _outputs(n: int, m: int, l: int, path: int, n_ws: int, dtype, dev: int):
    """y (N, M, L), the workspace's address (0: none) and the tensor that
    holds it. On the decode path the workspace is xA (rows x r f32), kept
    behind y in y's own allocation, so the call allocates once; else it is a
    tensor of its own, kept until the launch is queued."""
    if path == DECODE:
        off = -(-n * m * l // 8) * 8  # xA starts on 16 bytes
        buf = torch.empty((off + 2 * n_ws,), dtype=dtype, device=dev)
        return buf.as_strided((n, m, l), (m * l, l, 1)), buf.data_ptr() + 2 * off, buf
    y = torch.empty((n, m, l), dtype=dtype, device=dev)
    if not n_ws:
        return y, 0, None
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev)
    return y, ws.data_ptr(), ws


_launch = {}  # library name -> its launch function, once loaded


def fused_matmul(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    scale: Optional[torch.Tensor] = None, *, backward: bool = False,
    blocks: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """y[n] = x[n] @ w + scale[n] * (x[n] @ a[n]) @ b[n].

    x: (N, M, K); w: (K, L) shared, contiguous or a transposed view of a
    contiguous (L, K) tensor; a: (N, K, r); b: (N, r, L); scale: (N,) f32 or
    None; bf16 or f32, r <= 128. ``backward`` marks the backward's dx call:
    its launch is counted under "bwd" in ``fused_matmul.launches`` (keyed
    by direction and path; ``kernels/launches.py`` reads them).
    ``blocks``: ``[k_splits]``, the K ranges the "wgmma" and "ffma" paths
    take in place of their plan's choice (clamped as the plan clamps; the
    autotuner's candidate), or None; the plain version ignores it."""
    if x.is_cpu:
        return _ref.fused_matmul_ref(x, w, a, b, scale)
    dev = _device(x, "fused_matmul")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or a.requires_grad
                                    or b.requires_grad
                                    or (scale is not None and scale.requires_grad)):
        check_no_graph("fused_matmul", x, w, a, b, scale)  # raises
    if w.dim() != 2:
        raise ValueError(f"fused_matmul: w {tuple(w.shape)} must be 2-D")
    kw, l = w.shape
    dt = x.dtype
    # the checks that pass in the common case, cheaply; _check_lora and
    # layout run, and raise with the reason, only when one fails
    if not (x.dim() == 3 and a.dim() == 3 and b.dim() == 3 and dt in DTYPE_CODES
            and a.dtype == dt and b.dtype == dt and w.dtype == dt
            and a.get_device() == dev and b.get_device() == dev and w.get_device() == dev
            and x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        _check_lora("fused_matmul", x, a, b, l)
    n, m, k = x.shape
    na, ka, r = a.shape
    if (na, ka) != (n, k) or b.shape != (n, r, l) or not 1 <= r <= MAX_RANK:
        _check_lora("fused_matmul", x, a, b, l)
    if kw != k or w.dtype != dt or w.get_device() != dev:
        layout(w, "w", (k, l), dt, x.device)  # raises, saying why
    trans_w = _transposed(w, "w")
    s = _scale(scale, n, dev)
    if n * m * l == 0:
        return torch.empty((n, m, l), dtype=dt, device=dev)
    code = DTYPE_CODES[dt]
    xp, wp, ap, bp = x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr()
    splits = k_splits(blocks)
    path, n_ws = _plan("fused", n, m, k, l, r, code, int((xp | wp) % 16 == 0),
                       int((ap | bp) % 16 == 0), int(trans_w), splits)
    y, ws, keep = _outputs(n, m, l, path, n_ws, dt, dev)
    launch = _launch.get("fused")
    if launch is None:
        launch = _launch["fused"] = _build.load("fused").plora_fused_matmul
    rc = launch(_ARGS.pack(xp, wp, ap, bp, s, y.data_ptr(), ws, n, m, k, l, r, code, trans_w,
                           splits, torch._C._cuda_getCurrentRawStream(dev)))
    del keep
    if rc:
        _build.check(_build.load("fused"), rc, "fused_matmul")
    fused_matmul.launches["bwd" if backward else "fwd", PATHS[path]] += 1
    return y


# (direction, path) -> launches: the forward's and dx's
fused_matmul.launches = {(d, p): 0 for d in ("fwd", "bwd") for p in PATHS}


def _q_operands(x, codes, scales, a, b):
    """(n, m, k, l, r, mode, blk) of a quantized call, after the checks that
    refuse what the kernel does not take."""
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
    return n, m, k, l, r, mode, blk


def fused_matmul_q(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, a: torch.Tensor,
    b: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
    blocks: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """y[n] = x[n] @ deq(W) + scale[n] * (x[n] @ a[n]) @ b[n], W given as
    int8 codes (K, L) + f32 scales (1, L), or nf4 codes (K/2, L) uint8 + f32
    block scales (K/blk, L); each W element is the f32 product code * scale
    cast once to x's dtype. Other operands, and ``blocks``, as
    :func:`fused_matmul`."""
    if x.is_cpu:
        return _ref.fused_matmul_q_ref(x, codes, scales, a, b, scale)
    dev = _device(x, "fused_matmul_q")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, b, scale)):
        check_no_graph("fused_matmul_q", x, a, b, scale)  # raises
    n, m, k, l, r, mode, blk = _q_operands(x, codes, scales, a, b)
    s = _scale(scale, n, dev)
    if n * m * l == 0:
        return torch.empty((n, m, l), dtype=x.dtype, device=dev)
    code = DTYPE_CODES[x.dtype]
    splits = k_splits(blocks)
    path, n_ws = _plan("fused_q", n, m, k, l, r, code, int(_q_aligned(x, codes, scales)),
                       int(_aligned16(a, b)), splits=splits)
    y, ws, keep = _outputs(n, m, l, path, n_ws, x.dtype, dev)
    launch = _launch.get("fused_q")
    if launch is None:
        launch = _launch["fused_q"] = _build.load("fused_q").plora_fused_matmul_q
    rc = launch(_ARGS_Q.pack(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), a.data_ptr(), b.data_ptr(), s,
        y.data_ptr(), ws, n, m, k, l, r, code, mode, blk, splits,
        torch._C._cuda_getCurrentRawStream(dev),
    ))
    del keep
    if rc:
        _build.check(_build.load("fused_q"), rc, "fused_matmul_q")
    fused_matmul_q.launches["fwd", PATHS[path]] += 1
    return y


fused_matmul_q.launches = {("fwd", p): 0 for p in PATHS}


def fused_matmul_path(x: torch.Tensor, w: torch.Tensor, r: int,
                      a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None) -> str:
    """Which path ``csrc/fused.cuh``'s plan gives :func:`fused_matmul` on
    these CUDA operands (x (N, M, K), w (K, L), rank r): "decode", "wgmma",
    "ffma" or "split3". The plan reads only shapes, dtype, W's layout and
    alignment; A and B, when not given, count as 16-byte aligned (as a
    fresh allocation is)."""
    _device(x, "fused_matmul_path")
    n, m, k = x.shape
    trans_w = _transposed(w, "w")
    ab = _aligned16(*(t for t in (a, b) if t is not None))
    return PATHS[_plan("fused", n, m, k, w.shape[1], r, DTYPE_CODES[x.dtype],
                       int(_aligned16(x, w)), int(ab), int(trans_w))[0]]


def fused_matmul_splits(x: torch.Tensor, w: torch.Tensor, r: int,
                        a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None, *,
                        blocks: Optional[Sequence[int]] = None) -> int:
    """The K ranges of the base product that :func:`fused_matmul` takes on
    these CUDA operands (with ``blocks``: the request, as the plan clamps
    it); operands as :func:`fused_matmul_path`."""
    _device(x, "fused_matmul_splits")
    n, m, k = x.shape
    trans_w = _transposed(w, "w")
    ab = _aligned16(*(t for t in (a, b) if t is not None))
    return _plan_info("fused", n, m, k, w.shape[1], r, DTYPE_CODES[x.dtype],
                      int(_aligned16(x, w)), int(ab), int(trans_w), k_splits(blocks))[2]


def fused_matmul_q_path(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, r: int,
                        a: Optional[torch.Tensor] = None,
                        b: Optional[torch.Tensor] = None) -> str:
    """:func:`fused_matmul_path` for :func:`fused_matmul_q`: the same plan."""
    _device(x, "fused_matmul_q_path")
    n, m, k = x.shape
    ab = _aligned16(*(t for t in (a, b) if t is not None))
    return PATHS[_plan("fused_q", n, m, k, codes.shape[1], r, DTYPE_CODES[x.dtype],
                       int(_q_aligned(x, codes, scales)), int(ab))[0]]


def xa_rounded(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x @ A per adapter, f32 accumulation, one cast to x's dtype: the xA
    the backward uses (the reference's ``_xa``, ``fused.py:299-300``)."""
    return torch.bmm(x.float(), a.float()).to(x.dtype)


class _FusedLora(torch.autograd.Function):
    """``x @ W + alpha_n * (x_n @ A_n) @ B_n`` for 3-D x (N, M, d_in), with
    the reference's backward (``fused.py:354-431``).

    forward(x, w, a, b, alpha, wq, impl, remat, blocks): ``w`` the dense
    (d_in, d_out) weight, or None with ``wq`` the quantized ``{"codes",
    "scales"}`` dict; ``impl`` "fused_pallas" (the kernels) or
    "fused_plain" (their plain versions); ``remat`` "save" | "recompute";
    ``blocks`` the kernels' K-split override (None: their plans' choice),
    for the forward and dx.

    Backward: g_s = g * alpha; d(xA) = g_s @ B^T in f32, cast to x's dtype;
    dx = fused(g, W^T, B^T, A^T, alpha) through the fused kernel -- one
    fused cast, as on the Pallas path (the reference's XLA path sums two
    casts) -- on W dequantized once for a quantized base; xA recomputed
    and rounded to x's dtype, or saved under remat="save" on the plain
    path only (the Pallas path always recomputes); dA, dB by einsum in x's
    dtype; dW only when asked, never for a quantized base."""

    @staticmethod
    def forward(ctx, x, w, a, b, alpha, wq, impl, remat, blocks):
        plain = impl == "fused_plain"
        if plain:
            y = (_ref.fused_matmul_ref(x, w, a, b, alpha) if wq is None else
                 _ref.fused_matmul_q_ref(x, wq["codes"], wq["scales"], a, b, alpha))
        elif wq is not None:
            y = fused_matmul_q(x, wq["codes"], wq["scales"], a, b, alpha, blocks=blocks)
        else:
            y = fused_matmul(x, w, a, b, alpha, blocks=blocks)
        saved_xa = xa_rounded(x, a) if remat == "save" and plain else None
        ctx.save_for_backward(x, w, a, b, alpha, saved_xa)
        ctx.wq, ctx.impl, ctx.blocks = wq, impl, blocks
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
            dx = fused_matmul(g, wd.t(), bt, at, alpha, backward=True, blocks=ctx.blocks)
        xa = saved_xa if saved_xa is not None else xa_rounded(x, a)
        da = torch.einsum("nmk,nmr->nkr", x, dxa).to(a.dtype)
        db = torch.einsum("nmr,nml->nrl", xa, g_s).to(b.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("nmk,nml->kl", x, g).to(w.dtype)
        return dx, dw, da, db, None, None, None, None, None
