"""Quantized frozen base: the port of ``repro/kernels/quant.py``.

The base is frozen in training, so its projection weights may be stored
quantized and dequantized on the fly inside the fused kernel
(``csrc/fused_q.cu``):

  * ``int8``: symmetric per output channel. One f32 scale per output column
    (absmax over the K axis / 127); dequantization is ``codes * scales``.
  * ``nf4``: 4-bit block-scaled. Values snap to the 16-level NormalFloat
    codebook, two codes per uint8 along K (low nibble = even K row), one f32
    absmax scale per ``nf4_block(d_in)``-row slab per output column.

A quantized weight is a plain dict ``{"codes", "scales"}``; the scheme is
read from the codes' dtype (int8 -> per channel, uint8 -> nf4).

``quantize_weight`` runs in torch on the weight's own device with the
reference's numpy formula, bit for bit: ``torch.round`` rounds half to even
as ``np.rint`` does, ``torch.argmin`` takes the first minimum as
``np.argmin`` does, and every quotient and difference is an f32 operation
as in numpy. The nf4 search over the codebook is taken over slabs of rows,
so its (rows, d_out, 16) temporary stays bounded on a full-size layer.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("int8", "nf4")

# QLoRA NormalFloat-4 codebook: 16 quantiles of N(0,1) normalised to
# [-1, 1], asymmetric around the exact-zero level.
NF4_CODEBOOK = torch.tensor(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=torch.float32,
)

# elements of the nf4 codebook search's f32 temporary per slab (~1 GB)
_NF4_SLAB = 1 << 28

_CODEBOOKS = {}  # torch.device -> NF4_CODEBOOK on that device


def nf4_codebook(device) -> torch.Tensor:
    """``NF4_CODEBOOK`` on ``device``, copied on the first call for that
    device and the same tensor on every later one. The copy is queued
    without blocking: a blocking copy of a host tensor ends in a stream
    synchronize, which a CUDA graph capture refuses."""
    key = torch.device(device)
    cb = _CODEBOOKS.get(key)
    if cb is None:
        cb = _CODEBOOKS[key] = NF4_CODEBOOK.to(key, non_blocking=True)
    return cb


def is_quantized(w) -> bool:
    """True when ``w`` is a quantized-weight dict (vs a dense tensor)."""
    return isinstance(w, dict) and "codes" in w and "scales" in w


def quant_mode(w) -> str:
    """Scheme of a quantized weight, inferred from the codes' dtype."""
    dt = w["codes"].dtype
    if dt == torch.int8:
        return "int8"
    if dt == torch.uint8:
        return "nf4"
    raise ValueError(f"unrecognised quantized codes dtype {dt}")


def logical_shape(w) -> tuple:
    """Dense ``(..., d_in, d_out)`` shape a quantized weight dequantizes to."""
    shape = tuple(w["codes"].shape)
    if quant_mode(w) == "nf4":  # two K rows packed per uint8
        shape = shape[:-2] + (2 * shape[-2],) + shape[-1:]
    return shape


def base_storage(params, dense: bool = False):
    """How a frozen-base tree stores its weights, as ``CostModel``'s
    ``base_dtype`` names it: "int8" or "nf4" when its projections are
    quantized, else its dense dtype, "f32" or "bf16". With ``dense``:
    (that name, the dtype of its dense floating-point leaves -- for a
    quantized tree its embedding, norms and whatever else stays dense, as
    ``CostModel``'s ``dense_dtype`` names it). An MoE router is f32 in any
    tree and does not count."""
    modes, dtypes = set(), set()

    def walk(node):
        if is_quantized(node):
            modes.add(quant_mode(node))
        elif isinstance(node, dict):
            for k, v in node.items():
                if k != "router":
                    walk(v)
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            dtypes.add(node.dtype)

    walk(params)
    mode = next((m for m in MODES if m in modes), None)
    if mode is not None and not dense:
        return mode
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    if len(dtypes) != 1 or next(iter(dtypes)) not in names:
        raise ValueError(f"a frozen base of one float32 or bfloat16 dtype expected, got {dtypes}")
    held = names[dtypes.pop()]
    return (mode or held, held) if dense else held


def quantized_nbytes(w) -> int:
    """Resident bytes of a quantized weight (codes + scales)."""
    return sum(t.numel() * t.element_size() for t in (w["codes"], w["scales"]))


def nf4_block(d_in: int) -> int:
    """Block length along K: the largest power of two <= 64 dividing d_in."""
    b = 64
    while b > 1 and d_in % b:
        b //= 2
    return b


def quantize_weight(w: torch.Tensor, mode: str) -> dict:
    """Quantize a dense ``(..., d_in, d_out)`` weight on its device.

    Returns ``{"codes", "scales"}``. int8: codes int8 ``(..., d_in, d_out)``,
    scales f32 ``(..., 1, d_out)``. nf4: codes uint8 ``(..., d_in//2,
    d_out)`` (low nibble = even K row), scales f32 ``(..., d_in//block,
    d_out)``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    w = w.detach().to(torch.float32)
    if w.dim() < 2:
        raise ValueError(f"need (..., d_in, d_out), got shape {tuple(w.shape)}")
    if mode == "int8":
        absmax = w.abs().amax(dim=-2, keepdim=True)
        scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        codes = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
        return {"codes": codes, "scales": scales}
    d_in, d_out = w.shape[-2], w.shape[-1]
    if d_in % 2:
        raise ValueError(f"nf4 needs even d_in, got {d_in}")
    blk = nf4_block(d_in)
    lead = w.shape[:-2]
    wb = w.reshape(*lead, d_in // blk, blk, d_out)
    absmax = wb.abs().amax(dim=-2, keepdim=True)
    scales = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    normed = (wb / scales).reshape(-1, d_out)  # (rows, d_out), in [-1, 1]
    cb = nf4_codebook(w.device)
    idx = torch.empty(normed.shape, dtype=torch.uint8, device=w.device)
    step = max(1, _NF4_SLAB // (16 * d_out))
    for r0 in range(0, normed.shape[0], step):
        sl = normed[r0 : r0 + step]
        idx[r0 : r0 + step] = torch.argmin((sl[..., None] - cb).abs(), dim=-1).to(torch.uint8)
    pair = idx.reshape(*lead, d_in // 2, 2, d_out)
    codes = pair[..., 0, :] | (pair[..., 1, :] << 4)
    return {"codes": codes.contiguous(), "scales": scales[..., 0, :].contiguous()}


def dequantize(w: dict, dtype=torch.float32) -> torch.Tensor:
    """A ``{"codes", "scales"}`` dict as a dense tensor: the f32 product
    code * scale (nf4: codebook value * block scale), then cast to ``dtype``."""
    codes, scales = w["codes"], w["scales"]
    if codes.dtype == torch.int8:
        return (codes.to(torch.float32) * scales).to(dtype)
    lead = codes.shape[:-2]
    d_in, d_out = 2 * codes.shape[-2], codes.shape[-1]
    idx = torch.stack([codes & 0xF, codes >> 4], dim=-2).reshape(*lead, d_in, d_out)
    vals = nf4_codebook(codes.device)[idx.long()]
    nb = scales.shape[-2]
    vb = vals.reshape(*lead, nb, d_in // nb, d_out)
    return (vb * scales[..., :, None, :]).reshape(*lead, d_in, d_out).to(dtype)


# Only weights consumed through ``lora_linear`` are eligible (the names the
# reference lists, for every model family); embeddings and heads stay dense.
ELIGIBLE_NAMES = frozenset(
    {"q", "k", "v", "o", "q_a", "q_b", "kv_a", "gate", "up", "down", "zx", "out"}
)
EXCLUDE_SUBTREES = frozenset({"cross", "moe", "embed", "lm_head", "patch_proj"})


def quantize_base_params(params, mode: Optional[str]):
    """Quantize the eligible frozen-base projections of a parameter tree.

    Each eligible ``{"w": dense}`` becomes ``{"w": {"codes", "scales"}}``
    (bias and norms untouched); layer-stacked "blocks" leaves keep their
    leading axis. ``mode`` None or "none" is the identity."""
    if mode is None or mode == "none":
        return params

    def walk(node, name=None):
        if not isinstance(node, dict) or is_quantized(node):
            return node
        out = {}
        for k, v in node.items():
            if k in EXCLUDE_SUBTREES:
                out[k] = v
            elif (
                k == "w"
                and name in ELIGIBLE_NAMES
                and isinstance(v, torch.Tensor)
                and v.dim() >= 2
                and (mode == "int8" or v.shape[-2] % 2 == 0)
            ):
                out[k] = quantize_weight(v, mode)
            else:
                out[k] = walk(v, name=k)
        return out

    return walk(params)


def dequantize_base_params(params):
    """Inverse walk: every quantized dict becomes its dense f32 tensor."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        if is_quantized(node):
            return dequantize(node)
        return {k: walk(v) for k, v in node.items()}

    return walk(params)
