"""Packed-LoRA application, merging and per-adapter extraction.

``lora_linear`` is the entry point every model layer uses: a frozen base
matmul plus the packed adapter delta computed by ``repro_torch.kernels.ops``.
The activation carries the pack as the outermost batch factor — x has shape
(N*B, ..., d_in) with adapter n owning rows [n*B, (n+1)*B) — so packing never
changes the math of any single adapter. ``merge_adapter`` / ``merge_model``
fold one adapter into the base for serving without one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ops import FUSED, KernelConfig, fused_lora_linear, packed_lora_delta
from repro_torch.kernels.quant import dequantize, is_quantized, logical_shape


def lora_linear(
    x: torch.Tensor,
    params: dict,
    lora: Optional[dict],
    scales: Optional[torch.Tensor],
    n_pack: int = 1,
    *,
    kcfg: Optional[KernelConfig] = None,
) -> torch.Tensor:
    """y = x @ W (+ bias) + packed-LoRA delta.

    x: (N*B, ..., d_in); params: {"w": (d_in, d_out)[, "b": (d_out,)]}, the
    "w" dense or a quantized ``{"codes", "scales"}`` dict
    (``kernels/quant.py``); lora: {"a": (N, d_in, r), "b": (N, r, d_out)}
    or None; scales: (N,); kcfg: the kernel policy (impl, remat, the pack's
    ranks, the fused kernel's K-split override). With a fused impl the base projection and the delta run as one
    kernel pass -- a quantized W goes to the fused kernel as it is and is
    dequantized inside it -- and the bias is added after it; on the
    two-pass path a quantized W is dequantized up front, and the bias is
    added between base and delta -- the one reassociation between the two
    (as in the reference, ``packed_lora.py:67-68`` against ``:73-74``).
    """
    kc = kcfg or KernelConfig()
    impl_r = kc.resolved_impl()
    w = params["w"]
    quant = is_quantized(w)
    d_in, d_out = (logical_shape(w) if quant else w.shape)[-2:]
    lead = x.shape[:-1]
    if lora is not None:
        xp = x.reshape(n_pack, x.shape[0] // n_pack, -1, d_in)
    if lora is not None and impl_r in FUSED:
        y = fused_lora_linear(
            xp, w if quant else w.to(x.dtype), lora["a"].to(x.dtype), lora["b"].to(x.dtype),
            scales, impl=impl_r, remat=kc.remat, ranks=kc.ranks, blocks=kc.blocks,
        ).reshape(*lead, d_out)
        if "b" in params:
            y = y + params["b"].to(x.dtype)
        return y
    if quant:
        w = dequantize(w)
    y = x @ w.to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    if lora is not None:
        delta = packed_lora_delta(
            xp, lora["a"].to(x.dtype), lora["b"].to(x.dtype), scales,
            impl=impl_r, remat=kc.remat, ranks=kc.ranks,
        )
        y = y + delta.reshape(*lead, d_out)
    return y


def merge_adapter(base_w, lora: dict, scale: float, idx: int) -> torch.Tensor:
    """Fold adapter ``idx`` into the base weight: W + scale * A_idx @ B_idx
    (the paper's inference-time merge, the reference's
    ``packed_lora.py:96-112``). The pack axis is ``ndim - 3``, so plain
    (N, d, r) and layer-stacked (L, N, d, r) packs both work. A quantized
    W is dequantized first: the merged weight is dense (its codes no longer
    describe it). The result has the base's dtype; A @ B is taken in the
    adapter's dtype on the base's device."""
    if is_quantized(base_w):
        base_w = dequantize(base_w)
    a = torch.as_tensor(lora["a"]).to(base_w.device)
    b = torch.as_tensor(lora["b"]).to(base_w.device)
    delta = torch.matmul(a.select(a.dim() - 3, idx), b.select(b.dim() - 3, idx))
    return (base_w + scale * delta.to(base_w.dtype)).to(base_w.dtype)


def merge_model(base_params, lora_params, scales, idx: int):
    """A new base tree with adapter ``idx`` merged into every projection
    that carries one: a ``"w"`` leaf whose sibling LoRA dict holds ``"a"``
    and ``"b"``; every other leaf is shared, not copied (the reference's
    ``packed_lora.py:115-140``). The result serves with no adapter."""
    scale = float(scales[idx])

    def walk(bp, lp):
        if not isinstance(bp, dict):
            return bp
        out = {}
        for k, v in bp.items():
            if k == "w" and isinstance(lp, dict) and "a" in lp and "b" in lp:
                out[k] = merge_adapter(v, lp, scale, idx)
            else:
                sub = lp.get(k) if isinstance(lp, dict) else None
                out[k] = walk(v, sub if sub is not None else {})
        return out

    return walk(base_params, lora_params or {})


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def extract_adapter(lora_params, idx: int, ranks=None):
    """Slice adapter ``idx`` (unpadded to its rank if ``ranks`` is given)
    out of a pack, on the host in numpy. The pack dim is axis 1 under a
    layer-stacked "blocks" subtree and axis 0 elsewhere."""
    r = int(ranks[idx]) if ranks is not None else None

    def walk(t, in_blocks):
        if isinstance(t, dict):
            out = {k: walk(v, in_blocks or k == "blocks") for k, v in t.items()}
            if r is not None and set(out) == {"a", "b"}:
                out = {"a": out["a"][..., :r], "b": out["b"][..., :r, :]}
            return out
        ax = 1 if in_blocks else 0
        if isinstance(t, torch.Tensor):  # slice on the tensor's device, copy one adapter
            return _host(t.select(ax, idx))
        return np.take(_host(t), idx, axis=ax)

    return walk(lora_params, False)


def inject_adapter(lora_params, adapter, idx: int):
    """Inverse of :func:`extract_adapter`: write one adapter's weights into
    slot ``idx`` of a pack, zero-padding rank dims up to the pack's bucket.
    Runs on the host in numpy; the pack's leaves are copied, never mutated.
    The adapter may be a sparse sub-structure of the pack."""

    def put(leaf, sub, path):
        ax = 1 if "blocks" in path else 0
        sub = _host(sub)
        out = np.array(_host(leaf))  # host copy; the template stays intact
        last = path[-1] if path else None
        if last == "a" and sub.shape[-1] < out.shape[-1]:
            pad = [(0, 0)] * sub.ndim
            pad[-1] = (0, out.shape[-1] - sub.shape[-1])
            sub = np.pad(sub, pad)
        if last == "b" and sub.shape[-2] < out.shape[-2]:
            pad = [(0, 0)] * sub.ndim
            pad[-2] = (0, out.shape[-2] - sub.shape[-2])
            sub = np.pad(sub, pad)
        idxer = [slice(None)] * out.ndim
        idxer[ax] = idx
        out[tuple(idxer)] = sub.astype(out.dtype)
        return out

    def walk(pack, sub, path):
        if isinstance(pack, dict):
            return {
                k: (walk(v, sub[k], path + (k,)) if isinstance(sub, dict) and k in sub else v)
                for k, v in pack.items()
            }
        return put(pack, sub, path)

    return walk(lora_params, adapter, ())
