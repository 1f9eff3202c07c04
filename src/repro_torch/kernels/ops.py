"""Public ops for packed-LoRA computation, differentiable.

``packed_lora_delta(x, a, b, alpha)`` computes ``alpha_n * (x_n @ A_n) @ B_n``
for N packed adapters as two grouped products (``packed_matmul``), and
``fused_lora_linear(x, w, a, b, alpha)`` computes
``x @ W + alpha_n * (x_n @ A_n) @ B_n`` in one fused pass (``fused_matmul``,
or ``fused_matmul_q`` on a quantized W). Each is a ``torch.autograd.Function``
whose backward is the reference's (``repro/kernels/ops.py:_bwd`` and
``repro/kernels/fused.py:_bwd``) and launches the same kernels on transposed
operands, so gradients reach the LoRA leaves through the kernel path:

  case 1  dB    = (xA)^T @ g_s     case 3  dA = x^T @ d(xA)
  case 2  d(xA) = g_s @ B^T        case 4  dx = d(xA) @ A^T

(g_s = alpha * g). For 3-D x all four cases run through the grouped
kernel; for N-D x (what ``lora_linear`` passes: (N, B, S, d)) cases 2 and 4
do, and dA, dB are einsums over every token dim, as in the reference.

Backend selection (``KernelConfig.impl`` / the ``impl=`` argument):
  "auto", "pallas"        two passes through the packed_matmul kernel
  "fused", "fused_pallas" the fused kernel
  "plain", "fused_plain"  the plain PyTorch versions of the same two paths

The kernel wrappers pick by the tensor's device: on a CUDA tensor they
launch the hand-written kernel, on a CPU tensor they run its plain version.
The two "plain" names run the plain versions on any device; they are the
yardstick a check on the card compares the kernel path with. Any other name
raises.

Backward xA policy (``remat``): "save" keeps the (N, ..., r) xA of the
forward for the backward, "recompute" recomputes it; the two are
bit-identical (the same deterministic kernel on the same inputs). The
fused kernel keeps xA in f32 inside the kernel, so its backward always
recomputes a rounded xA, as the reference's Pallas path does.

Heterogeneous-rank packs: pass ``ranks=`` (the pack's per-adapter rank
tuple) and same-rank adapters run as ragged segments at their own rank: a
permutation gather, then per-segment slices of A and B at the true rank, so
the padding columns are never read and their gradients are structurally 0.
The permutation's index tensors are made once per (ranks, device), and a
rank tuple that is already sorted skips the gather and the scatter: no call
waits on the host.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fused import _FusedLora
from repro_torch.kernels.packed_matmul import packed_matmul, packed_matmul_pair
from repro_torch.kernels.quant import is_quantized

IMPLS = ("auto", "pallas", "fused", "fused_pallas", "plain", "fused_plain")
FUSED = ("fused_pallas", "fused_plain")
REMATS = ("save", "recompute")
# "save" costs one (N, ..., r <= 128) residual per projection, block-local
# under the checkpointed stack, and spares the backward a GEMM over the full
# d_in; the reference measured it the faster policy (ops.py:65-76).
DEFAULT_REMAT = "save"


# The default impl is context-local, as in the reference (ops.py:74-96):
# ``use_impl`` affects the calling context only, and new threads do not
# inherit it, so a cross-thread executor (the cluster runner) captures
# ``default_impl()`` at dispatch and passes it on as ``impl=``.
_IMPL_VAR: contextvars.ContextVar = contextvars.ContextVar("plora_impl", default="auto")


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    return impl


def default_impl() -> str:
    return _IMPL_VAR.get()


@contextlib.contextmanager
def use_impl(impl: str):
    """Scoped default: ``with use_impl("fused"): ...``."""
    token = _IMPL_VAR.set(_check_impl(impl))
    try:
        yield
    finally:
        _IMPL_VAR.reset(token)


def _resolve(impl: Optional[str]) -> str:
    """Map an impl name (None: the context default) to its path: "pallas" |
    "plain" (two passes) or "fused_pallas" | "fused_plain" (one fused
    pass)."""
    impl = _check_impl(impl or _IMPL_VAR.get())
    return {"auto": "pallas", "fused": "fused_pallas"}.get(impl, impl)


def _resolve_remat(remat: Optional[str]) -> str:
    remat = remat or DEFAULT_REMAT
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; known: {REMATS}")
    return remat


@dataclass(frozen=True)
class KernelConfig:
    """Kernel policy threaded down to every ``lora_linear`` call.

    impl       : backend name from ``IMPLS`` (None -> "auto")
    remat      : backward xA policy "save" | "recompute" (None -> DEFAULT_REMAT)
    ranks      : the pack's per-adapter rank tuple; a heterogeneous tuple runs
                 the delta as ragged same-rank segments (None -> every adapter
                 at the bucket rank)
    base_dtype : the frozen base's storage, None (dense) or "int8"/"nf4"
                 (kernels/quant.py); dispatch follows the weights themselves,
                 this names the policy a step was built for
    blocks     : the fused kernel's K-split override ``(k_splits,)`` (the
                 autotuner's choice, ``kernels/autotune.py``; None -> each
                 call's plan)
    """

    impl: Optional[str] = None
    remat: Optional[str] = None
    ranks: Optional[Tuple[int, ...]] = None
    base_dtype: Optional[str] = None
    blocks: Optional[Tuple[int, ...]] = None

    def resolved_impl(self) -> str:
        return _resolve(self.impl)

    def resolved_remat(self) -> str:
        return _resolve_remat(self.remat)


def rank_segments(
    ranks: Sequence[int],
) -> Tuple[Tuple[int, ...], Tuple[int, ...], List[Tuple[int, int, int]]]:
    """Group a pack's adapters into same-rank segments.

    Returns ``(order, inv, segments)``: ``order`` sorts adapters by rank
    (stable), ``inv`` undoes it, and each segment ``(lo, hi, r)`` is a
    contiguous run of rank-``r`` adapters in the sorted view."""
    n = len(ranks)
    order = tuple(sorted(range(n), key=lambda i: (ranks[i], i)))
    inv = tuple(int(i) for i in sorted(range(n), key=lambda i: order[i]))
    segments: List[Tuple[int, int, int]] = []
    lo = 0
    for hi in range(1, n + 1):
        if hi == n or ranks[order[hi]] != ranks[order[lo]]:
            segments.append((lo, hi, int(ranks[order[lo]])))
            lo = hi
    return order, inv, segments


def grouped_matmul(x, w, scale=None, *, impl: Optional[str] = None, backward: bool = False):
    """out[n] = scale[n] * x[n] @ w[n]. x may carry extra token dims
    (N, ..., K); they are flattened around the 3-D kernel. x and w may be
    transposed views of contiguous tensors (the kernel reads them in
    place). ``backward`` counts a launch as a backward case."""
    if impl != "pallas" and _resolve(impl) in ("plain", "fused_plain"):
        return _ref.packed_matmul_ref(x, w, scale)
    if x.dim() == 3:
        return packed_matmul(x, w, scale, backward=backward)
    out = packed_matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w, scale, backward=backward)
    return out.view(*x.shape[:-1], w.shape[-1])


def _bcast(alpha: torch.Tensor, ndim: int) -> torch.Tensor:
    return alpha.reshape(alpha.shape[0], *([1] * (ndim - 1)))


class _PackedLoraDelta(torch.autograd.Function):
    """alpha_n * (x_n @ A_n) @ B_n with the reference's backward
    (``ops.py:208-246``); forward(x, a, b, alpha, impl, remat) with impl
    "pallas" (the kernel) or "plain"."""

    @staticmethod
    def forward(ctx, x, a, b, alpha, impl, remat):
        if impl == "pallas":  # both passes in one wrapper call
            x3 = x if x.dim() == 3 else x.reshape(x.shape[0], -1, x.shape[-1])
            out, xa = packed_matmul_pair(x3, a, b, alpha)
            if x.dim() != 3:
                out, xa = out.view(*x.shape[:-1], b.shape[-1]), xa.view(*x.shape[:-1], a.shape[-1])
        else:
            xa = grouped_matmul(x, a, impl=impl)
            out = grouped_matmul(xa, b, alpha, impl=impl)
        ctx.save_for_backward(x, a, b, alpha, xa if remat == "save" else None)
        ctx.impl = impl
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, b, alpha, saved_xa = ctx.saved_tensors
        impl = ctx.impl
        g = g.to(x.dtype).contiguous()
        xa = saved_xa if saved_xa is not None else grouped_matmul(x, a, impl=impl)
        g_s = g * _bcast(alpha, g.ndim).to(g.dtype)
        if x.dim() == 3:
            db = grouped_matmul(xa.transpose(1, 2), g_s, impl=impl, backward=True)  # case 1
            dxa = grouped_matmul(g_s, b.transpose(1, 2), impl=impl, backward=True)  # case 2
            da = grouped_matmul(x.transpose(1, 2), dxa, impl=impl, backward=True)  # case 3
            dx = grouped_matmul(dxa, a.transpose(1, 2), impl=impl, backward=True)  # case 4
            return dx, da, db, None, None, None
        db = torch.einsum("n...r,n...k->nrk", xa, g_s)
        dxa = grouped_matmul(g_s, b.transpose(1, 2), impl=impl, backward=True)
        da = torch.einsum("n...d,n...r->ndr", x, dxa)
        dx = grouped_matmul(dxa, a.transpose(1, 2), impl=impl, backward=True)
        return dx, da.to(a.dtype), db.to(b.dtype), None, None, None


@functools.lru_cache(maxsize=None)
def _ragged_plan(ranks: Tuple[int, ...]):
    """``rank_segments(ranks)`` as tuples, and whether ``order`` is the
    identity (the ranks already sorted), once per rank tuple."""
    order, inv, segments = rank_segments(ranks)
    return order, inv, tuple(segments), order == tuple(range(len(ranks)))


_INDEX = {}  # (ranks, device) -> (order, inv) as int64 tensors on the device


def ragged_index(ranks: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (order, inv) permutation of ``rank_segments(ranks)`` as index
    tensors on ``device``, made on the first call for this (ranks, device)
    and the same tensors on every later one. The host-to-device copy is
    queued without blocking: a blocking copy of a fresh host tensor ends in a
    stream synchronize."""
    key = (tuple(int(r) for r in ranks), torch.device(device))
    idx = _INDEX.get(key)
    if idx is None:
        order, inv, _, _ = _ragged_plan(key[0])
        idx = _INDEX[key] = tuple(
            torch.tensor(v, dtype=torch.int64).to(key[1], non_blocking=True) for v in (order, inv))
    return idx


def _ragged_call(fn, x, a, b, alpha, ranks):
    """Run ``fn(x_seg, a_seg, b_seg, alpha_seg)`` over same-rank segments,
    each segment's weights sliced to its true rank (made contiguous for the
    kernels), and reassemble the outputs in slot order. Every step is
    differentiable, and the sliced-off padding gets exactly zero gradient.
    Sorted ranks need no permutation: the segments are slices of the pack."""
    if len(ranks) != x.shape[0]:
        raise ValueError(f"ranks {ranks} do not match pack size {x.shape[0]}")
    _, _, segments, identity = _ragged_plan(tuple(ranks))
    if identity:
        xs, a_s, b_s, al_s = x, a, b, alpha
    else:
        o, inv = ragged_index(ranks, x.device)
        xs, a_s, b_s, al_s = x[o], a[o], b[o], alpha[o]
    outs = [
        fn(
            xs[lo:hi].contiguous(),
            a_s[lo:hi, :, :r].contiguous(),
            b_s[lo:hi, :r, :].contiguous(),
            al_s[lo:hi].contiguous(),
        )
        for lo, hi, r in segments
    ]
    out = torch.cat(outs, dim=0)
    return out if identity else out[inv]


def packed_lora_delta(
    x, a, b, alpha, *,
    impl: Optional[str] = None,
    remat: Optional[str] = None,
    ranks: Optional[Tuple[int, ...]] = None,
):
    """alpha_n * (x_n @ A_n) @ B_n for N packed adapters, two grouped
    products with xA rounded to ``x.dtype`` between them.

    x: (N, T, d) or (N, ..., d); a: (N, d, r); b: (N, r, k); alpha: (N,)
    -> (N, ..., k). ``remat`` picks the backward xA policy."""
    impl_r = {"fused_pallas": "pallas", "fused_plain": "plain"}.get(
        _resolve(impl), _resolve(impl)
    )
    remat_r = _resolve_remat(remat)
    alpha = alpha.to(torch.float32).contiguous()

    def delta(xs, as_, bs, als):
        return _PackedLoraDelta.apply(xs.contiguous(), as_, bs, als, impl_r, remat_r)

    if ranks is not None and len(set(ranks)) > 1:
        return _ragged_call(delta, x, a, b, alpha, ranks)
    return delta(x, a.contiguous(), b.contiguous(), alpha)


def fused_lora_linear(
    x, w, a, b, alpha, *,
    impl: Optional[str] = None,
    remat: Optional[str] = None,
    ranks: Optional[Tuple[int, ...]] = None,
    blocks: Optional[Tuple[int, ...]] = None,
):
    """Fused ``x @ W + alpha_n * (x_n @ A_n) @ B_n`` with the same ragged-rank
    segmentation as :func:`packed_lora_delta` (each same-rank segment runs
    its own fused pass).

    x: (N, ..., d_in); w: (d_in, d_out) dense, or a quantized ``{"codes",
    "scales"}`` dict (dequantized inside the kernel); a/b/alpha as usual;
    ``blocks``: the kernel's K-split override ``(k_splits,)`` for every
    segment's forward and dx (None: each call's plan)."""
    impl_r = {"pallas": "fused_pallas", "plain": "fused_plain"}.get(
        _resolve(impl), _resolve(impl)
    )
    remat_r = _resolve_remat(remat)
    alpha = alpha.to(torch.float32).contiguous()
    wq = w if is_quantized(w) else None
    wd = None if wq is not None else w.contiguous()

    def fused(xs, as_, bs, als):
        x3 = xs.reshape(xs.shape[0], -1, xs.shape[-1]).contiguous()
        y = _FusedLora.apply(x3, wd, as_, bs, als, wq, impl_r, remat_r, blocks)
        return y.reshape(*xs.shape[:-1], y.shape[-1])

    if ranks is not None and len(set(ranks)) > 1:
        return _ragged_call(fused, x, a, b, alpha, ranks)
    return fused(x, a.contiguous(), b.contiguous(), alpha)
