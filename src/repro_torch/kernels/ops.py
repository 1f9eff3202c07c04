"""Public ops for packed-LoRA computation (forward only in this slice).

``packed_lora_delta(x, a, b, alpha)`` computes ``alpha_n * (x_n @ A_n) @ B_n``
for N packed adapters as two grouped products (``packed_matmul``), and
``fused_lora_linear(x, w, a, b, alpha)`` computes
``x @ W + alpha_n * (x_n @ A_n) @ B_n`` in one fused pass (``fused_matmul``).

Backend selection (``KernelConfig.impl`` / the ``impl=`` argument):
  "auto", "pallas"        two passes through the packed_matmul kernel
  "fused", "fused_pallas" the fused kernel
  "plain", "fused_plain"  the plain PyTorch versions of the same two paths

The kernel wrappers pick by the tensor's device: on a CUDA tensor they
launch the hand-written kernel, on a CPU tensor they run its plain version.
The two "plain" names run the plain versions on any device; they are the
yardstick a check on the card compares the kernel path with. Any other name
raises.

Heterogeneous-rank packs: pass ``ranks=`` (the pack's per-adapter rank
tuple) and same-rank adapters run as ragged segments at their own rank, the
padding columns sliced off before the kernel sees them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fused import fused_matmul
from repro_torch.kernels.packed_matmul import packed_matmul

IMPLS = ("auto", "pallas", "fused", "fused_pallas", "plain", "fused_plain")
FUSED = ("fused_pallas", "fused_plain")


def _resolve(impl: Optional[str]) -> str:
    """Map an impl name to its path: "pallas" | "plain" (two passes) or
    "fused_pallas" | "fused_plain" (one fused pass)."""
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    return {"auto": "pallas", "fused": "fused_pallas"}.get(impl, impl)


@dataclass(frozen=True)
class KernelConfig:
    """Kernel policy threaded down to every ``lora_linear`` call.

    impl  : backend name from ``IMPLS`` (None -> "auto")
    ranks : the pack's per-adapter rank tuple; a heterogeneous tuple runs the
            delta as ragged same-rank segments (None -> every adapter at the
            bucket rank)
    """

    impl: Optional[str] = None
    ranks: Optional[Tuple[int, ...]] = None

    def resolved_impl(self) -> str:
        return _resolve(self.impl)


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


def grouped_matmul(x, w, scale=None, *, impl: Optional[str] = None):
    """out[n] = scale[n] * x[n] @ w[n]. x may carry extra token dims
    (N, ..., K); they are flattened around the 3-D kernel."""
    lead = x.shape[1:-1]
    if _resolve(impl) in ("plain", "fused_plain"):
        return _ref.packed_matmul_ref(x, w, scale)
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
    out = packed_matmul(x3, w.contiguous(), scale)
    return out.reshape(x.shape[0], *lead, w.shape[-1])


def _ragged_call(fn, x, a, b, alpha, ranks):
    """Run ``fn(x_seg, a_seg, b_seg, alpha_seg)`` over same-rank segments,
    each segment's weights sliced to its true rank (made contiguous for the
    kernels), and reassemble the outputs in slot order."""
    if len(ranks) != x.shape[0]:
        raise ValueError(f"ranks {ranks} do not match pack size {x.shape[0]}")
    order, inv, segments = rank_segments(ranks)
    dev = x.device
    o = torch.tensor(order, device=dev)
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
    return torch.cat(outs, dim=0)[torch.tensor(inv, device=dev)]


def _delta(x, a, b, alpha, impl):
    xa = grouped_matmul(x, a, impl=impl)
    return grouped_matmul(xa, b, alpha, impl=impl)


def packed_lora_delta(
    x, a, b, alpha, *,
    impl: Optional[str] = None,
    ranks: Optional[Tuple[int, ...]] = None,
):
    """alpha_n * (x_n @ A_n) @ B_n for N packed adapters, two grouped
    products with xA rounded to ``x.dtype`` between them.

    x: (N, T, d); a: (N, d, r); b: (N, r, k); alpha: (N,) -> (N, T, k)."""
    impl_r = {"fused_pallas": "pallas", "fused_plain": "plain"}.get(
        _resolve(impl), _resolve(impl)
    )
    alpha = alpha.to(torch.float32).contiguous()
    if ranks is not None and len(set(ranks)) > 1:
        return _ragged_call(
            lambda xs, as_, bs, als: _delta(xs, as_, bs, als, impl_r),
            x, a, b, alpha, ranks,
        )
    return _delta(x, a, b, alpha, impl_r)


def _fused(x, w, a, b, alpha, impl):
    lead = x.shape[1:-1]
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    if impl == "fused_plain":
        out = _ref.fused_matmul_ref(x3, w, a, b, alpha)
    else:
        out = fused_matmul(
            x3.contiguous(), w.contiguous(), a.contiguous(), b.contiguous(), alpha
        )
    return out.reshape(x.shape[0], *lead, w.shape[-1])


def fused_lora_linear(
    x, w, a, b, alpha, *,
    impl: Optional[str] = None,
    ranks: Optional[Tuple[int, ...]] = None,
):
    """Fused ``x @ W + alpha_n * (x_n @ A_n) @ B_n`` with the same ragged-rank
    segmentation as :func:`packed_lora_delta` (each same-rank segment runs
    its own fused pass).

    x: (N, ..., d_in); w: (d_in, d_out); a/b/alpha as usual."""
    impl_r = {"pallas": "fused_pallas", "plain": "fused_plain"}.get(
        _resolve(impl), _resolve(impl)
    )
    alpha = alpha.to(torch.float32).contiguous()
    if ranks is not None and len(set(ranks)) > 1:
        return _ragged_call(
            lambda xs, as_, bs, als: _fused(xs, w, as_, bs, als, impl_r),
            x, a, b, alpha, ranks,
        )
    return _fused(x, w, a, b, alpha, impl_r)
