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

``packed_matmul_path(x, w)`` names the path the kernel's plan takes for a
call: "decode" (bf16 at most 16 rows per adapter: one-launch streaming
kernels), "mma" (tensor cores, bf16 training and prefill shapes),
"f32skinny" (streaming FFMA kernels, f32 training and prefill shapes) or
"fma".
The plan and its workspace size are asked once per shape and cached, so a
launch is one ctypes call, whose arguments go as one packed block.

``packed_matmul_pair(x, a, b, scale)`` returns both products of a LoRA
delta, ``xa = x @ a`` and ``out = scale * (xa @ b)``, bit for bit what two
``packed_matmul`` calls return; when both take the "decode" path it is one
ctypes call whose two launches overlap (the second is a programmatic
dependent launch of the first).
"""
from __future__ import annotations

import functools
import struct
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
    return bool(_transposed(t, name))


def _transposed(t: torch.Tensor, name: str) -> int:
    """0 when ``t`` (2-D or more) is contiguous, 1 when it is the transpose
    of its last two dims of a contiguous tensor (the kernels read both in
    place); raise otherwise. The strides say it without building a view,
    dims of size 1 ignored, as ``is_contiguous`` does."""
    if t.is_contiguous():
        return 0
    *lead, a, b = t.shape
    *lead_strides, s1, s2 = t.stride()
    ok = (a == 1 or s1 == 1) and (b == 1 or s2 == a)
    expect = a * b
    for size, stride in zip(reversed(lead), reversed(lead_strides)):
        ok = ok and (size == 1 or stride == expect)
        expect *= size
    if ok:
        return 1
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


# PATH_FMA, PATH_MMA, PATH_DECODE, PATH_F32SKINNY of csrc/skinny.cuh
PATHS = ("fma", "mma", "decode", "f32skinny")
DECODE = PATHS.index("decode")
# plora_packed_matmul's one argument: a block of 13 int64, and
# plora_packed_lora_delta's, of 12 (csrc/packed_matmul.cu)
_ARGS = struct.Struct("<13q")
_PAIR_ARGS = struct.Struct("<12q")
_lib = _launch = _launch_pair = None  # the library and its launch functions, once loaded


def _library():
    global _lib, _launch, _launch_pair
    if _lib is None:
        _lib = _build.load("packed_matmul")
        _launch = _lib.plora_packed_matmul
        _launch_pair = _lib.plora_packed_lora_delta
    return _lib


@functools.lru_cache(maxsize=None)
def _pair_decodes(n: int, m: int, k: int, r: int, l: int, aligned: int) -> bool:
    """Whether both bf16 passes of a delta, x (N, M, K) @ a (N, K, r) and
    then (N, M, r) @ b (N, r, L), take the "decode" path: x, a and b
    row-major, b on 16 bytes, x and a too with ``aligned`` (xa and out are
    fresh, aligned allocations)."""
    return (_plan(n, m, k, r, 1, 0, 0, aligned)[0] == DECODE
            and _plan(n, m, r, l, 1, 0, 0, 1)[0] == DECODE)


@functools.lru_cache(maxsize=None)
def _plan(n: int, m: int, k: int, l: int, code: int, tx: int, tw: int, aligned: int):
    """(path, f32 workspace elements) of a call, from ``csrc/skinny.cuh``'s
    plan -- the one the launch reads. It reads only these sizes, the
    dtype, the layouts and the 16-byte alignment of x and w (the output is
    a fresh, aligned allocation), so it is asked once per shape."""
    lib = _library()
    return (lib.plora_packed_matmul_path(n, m, k, l, code, tx, tw, aligned),
            lib.plora_packed_matmul_workspace(n, m, k, l, code, tx, tw, aligned))


def _key(x: torch.Tensor, w: torch.Tensor, dev: int, name: str):
    """The plan's inputs for x (N, M, K) and w (N, K, L) on CUDA device
    ``dev``, after the checks that refuse what the kernel does not take."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} must be 3-D")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    n, m, k = x.shape
    nw, kw, l = w.shape
    if nw != n or kw != k:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected {(n, k, l)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w: dtype {w.dtype}, expected {x.dtype}")
    if w.get_device() != dev:
        raise ValueError(f"w: on {w.device}, expected {x.device}")
    aligned = int((x.data_ptr() | w.data_ptr()) % 16 == 0)
    return n, m, k, l, code, _transposed(x, "x"), _transposed(w, "w"), aligned


def _device(x: torch.Tensor, name: str) -> int:
    """x's CUDA device index; raise unless it is the current device."""
    dev = x.get_device()
    if dev < 0 or dev != torch.cuda.current_device():
        check_cuda(name, x)  # raises, naming the device
    return dev


def packed_matmul(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
    backward: bool = False,
) -> torch.Tensor:
    """out[n] = scale[n] * (x[n] @ w[n]).

    x: (N, M, K); w: (N, K, L), each contiguous or a transposed view of a
    contiguous tensor; scale: (N,) f32 or None; bf16 or f32. ``backward``
    marks a launch for a backward case: it is counted under "bwd" in
    ``packed_matmul.launches`` (keyed by direction and path)."""
    if x.is_cpu:
        return packed_matmul_ref(x, w, scale)
    dev = _device(x, "packed_matmul")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or (scale is not None and scale.requires_grad)):
        check_no_graph("packed_matmul", x, w, scale)  # raises
    n, m, k, l, code, tx, tw, aligned = _key(x, w, dev, "packed_matmul")
    s = _scale_address(scale, n, dev, x)
    out = torch.empty((n, m, l), dtype=x.dtype, device=dev)
    if n * m * l == 0:
        return out
    path, n_ws = _plan(n, m, k, l, code, tx, tw, aligned)
    # f32 partial sums of the FMA path's split K loop (csrc/tile.cuh)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev) if n_ws else None
    rc = (_launch or _library().plora_packed_matmul)(_ARGS.pack(
        x.data_ptr(), w.data_ptr(), s, out.data_ptr(), ws.data_ptr() if n_ws else 0,
        n, m, k, l, code, tx, tw,
        torch._C._cuda_getCurrentRawStream(dev),  # the current stream, as an int
    ))
    if rc:
        _build.check(_lib, rc, "packed_matmul")
    packed_matmul.launches["bwd" if backward else "fwd", PATHS[path]] += 1
    return out


# (direction, path) -> launches: the forward's and the backward cases'
packed_matmul.launches = {(d, p): 0 for d in ("fwd", "bwd") for p in PATHS}


def _scale_address(scale: Optional[torch.Tensor], n: int, dev: int, x: torch.Tensor) -> int:
    """The (N,) f32 scale's address on CUDA device ``dev``, 0 for None."""
    if scale is None:
        return 0
    if scale.dtype != torch.float32 or scale.shape != (n,) or scale.get_device() != dev \
            or not scale.is_contiguous():
        check_operand(scale, "scale", (n,), torch.float32, x.device)  # raises, saying why
    return scale.data_ptr()


def packed_matmul_pair(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: Optional[torch.Tensor] = None,
):
    """(out, xa) of a LoRA delta's two grouped products: xa = x @ a, rounded
    to x.dtype, and out[n] = scale[n] * (xa[n] @ b[n]) -- what
    ``packed_matmul(x, a)`` and then ``packed_matmul(xa, b, scale)`` return,
    bit for bit. x: (N, M, K); a: (N, K, r); b: (N, r, L).

    On CUDA, when both passes take the "decode" path, one ctypes call
    launches both kernels (the second a programmatic dependent launch that
    streams b while the first runs) and counts two launches; otherwise it
    makes the two calls."""
    if x.is_cpu:
        xa = packed_matmul_ref(x, a)
        return packed_matmul_ref(xa, b, scale), xa
    dev = _device(x, "packed_matmul_pair")
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad or b.requires_grad
                                    or (scale is not None and scale.requires_grad)):
        check_no_graph("packed_matmul_pair", x, a, b, scale)  # raises
    n, m, k, r, code, tx, ta, aligned = _key(x, a, dev, "packed_matmul_pair")
    l = b.shape[-1]
    if code != 1 or tx or ta or b.shape != (n, r, l) or b.dtype != x.dtype \
            or b.get_device() != dev or not b.is_contiguous() or b.data_ptr() % 16 \
            or not _pair_decodes(n, m, k, r, l, aligned):
        xa = packed_matmul(x, a)
        return packed_matmul(xa, b, scale), xa
    s = _scale_address(scale, n, dev, x)
    out = torch.empty((n, m, l), dtype=x.dtype, device=dev)
    xa = torch.empty((n, m, r), dtype=x.dtype, device=dev)
    rc = (_launch_pair or _library().plora_packed_lora_delta)(_PAIR_ARGS.pack(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), s, xa.data_ptr(), out.data_ptr(),
        n, m, k, r, l, torch._C._cuda_getCurrentRawStream(dev),
    ))
    if rc:
        _build.check(_lib, rc, "packed_matmul_pair")
    packed_matmul.launches["fwd", "decode"] += 2
    return out, xa


def packed_matmul_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which path ``csrc/skinny.cuh``'s plan gives :func:`packed_matmul` on
    these CUDA operands: "decode" (``csrc/decode_rows.cuh``'s streaming
    kernels: bf16, at most 16 rows per adapter, x and w row-major, K and L
    multiples of 8, L or K at most 128, pointers aligned to 16 bytes),
    "mma" (the tensor-core kernels: the same with more than 16 rows, either
    operand also transposed), "f32skinny" (``csrc/fskinny.cuh``'s streaming
    FFMA kernels: f32, more than 16 rows, x row-major, K and L multiples of
    4, L or K at most 128, pointers aligned to 16 bytes) or "fma"
    (``csrc/tile.cuh``'s FMA kernel). The plan reads only shapes, dtype,
    layouts and alignment."""
    return PATHS[_plan(*_key(x, w, _device(x, "packed_matmul_path"), "packed_matmul_path"))[0]]
