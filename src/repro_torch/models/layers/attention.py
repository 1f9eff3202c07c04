"""Causal grouped-query attention: prefill over query chunks, cached decode.

Attention is not a kernel of the reference (it is plain jnp there), so it
is plain PyTorch here: scores in f32, masked with -1e30, softmax in f32,
probabilities cast to the value type — as the reference rounds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core.adapter import init_lora_pair
from repro_torch.core.packed_lora import lora_linear
from repro_torch.models.layers.common import init_linear
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


def _attend_chunk(q, k, v, qpos, kpos, scale, window: int = 0):
    """Causal attention of a query chunk, within ``window`` positions when
    it is set. q: (B, cq, H, D); k/v: (B, Sk, KV, D); returns (B, cq, H, D)."""
    b, cq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, cq, kv, h // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, cq, h, v.shape[-1])


def flash_attention(q, k, v, *, window: int = 0, chunk_q: int = 512,
                    scale: Optional[float] = None):
    """Causal attention over query chunks of ``chunk_q`` (scores never
    exceed chunk_q x Sk). q: (B, Sq, H, D); k/v: (B, Sk, KV, D). With a
    ``window`` and more than one chunk, each chunk reads only the K/V band
    its queries reach, [c0 - window + 1, c0 + chunk_q) (the reference's
    band slice, ``attention.py:84-104``): local layers cost
    O(Sq x (window + chunk_q)), not O(Sq^2)."""
    sq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    if sq <= chunk_q:
        return _attend_chunk(q, k, v, kpos[:sq], kpos, scale, window)
    outs = []
    for c0 in range(0, sq, chunk_q):
        qc = q[:, c0 : c0 + chunk_q]
        qpos = kpos[c0 : c0 + qc.shape[1]]
        lo, hi = (max(0, c0 - window + 1), c0 + qc.shape[1]) if window else (0, k.shape[1])
        outs.append(_attend_chunk(qc, k[:, lo:hi], v[:, lo:hi], qpos, kpos[lo:hi], scale, window))
    return torch.cat(outs, dim=1)


def decode_attention(q, k, v, pos, *, window: int = 0, scale=None):
    """One-token attention against a cache. q: (B, 1, H, D); k/v: (B, Smax,
    KV, D); pos: () shared position or (B,) per-row positions (continuous
    batching). Cache entries beyond a row's position, or ``window`` or more
    positions behind it, are masked."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    qg = q.reshape(b, kv, h // kv, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    posv = pos.reshape(-1, 1)  # (B, 1) or (1, 1)
    mask = kpos[None, :] <= posv
    if window:
        mask &= (posv - kpos[None, :]) < window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype), v)
    return out.reshape(b, 1, h, v.shape[-1])


def init_gqa(gen, acfg: AttentionConfig, d_model, meta, targets, dtype=torch.float32, device=None):
    h, kv, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    params = {
        "q": init_linear(gen, d_model, h * hd, acfg.use_bias, dtype, device),
        "k": init_linear(gen, d_model, kv * hd, acfg.use_bias, dtype, device),
        "v": init_linear(gen, d_model, kv * hd, acfg.use_bias, dtype, device),
        "o": init_linear(gen, h * hd, d_model, False, dtype, device),
    }
    lora = {}
    if meta is not None:
        for nm in ("q", "k", "v", "o"):
            if nm in targets:
                d_in, d_out = params[nm]["w"].shape
                lora[nm] = init_lora_pair(gen, meta, d_in, d_out, dtype, device)
    return params, lora


def apply_gqa(
    params, lora, scales, x, *,
    acfg: AttentionConfig,
    n_pack: int,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    window: int = 0,
    cache: Optional[dict] = None,
    pos=None,
    make_cache: bool = False,
    chunk_q: int = 512,
    kcfg=None,
):
    """x: (NB, S, d). Returns (out, cache or None). ``window``: the layer's
    sliding window (0: full causal attention).

    With a cache (single-token decode) this step's k/v are written into it
    in place at ``pos`` — a (NB,) vector writes each row at its own slot —
    and the updated cache is returned."""
    lo = lora or {}
    nb, s, _ = x.shape
    h, kvh, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    q = lora_linear(x, params["q"], lo.get("q"), scales, n_pack, kcfg=kcfg).reshape(nb, s, h, hd)
    k = lora_linear(x, params["k"], lo.get("k"), scales, n_pack, kcfg=kcfg).reshape(nb, s, kvh, hd)
    v = lora_linear(x, params["v"], lo.get("v"), scales, n_pack, kcfg=kcfg).reshape(nb, s, kvh, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is not None:
        if s != 1:
            raise ValueError("cached attention takes one token per row")
        ck, cv = cache["k"], cache["v"]
        rows = torch.arange(nb, device=x.device)
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        out = decode_attention(q, ck, cv, pos, window=window)
        new_cache = cache
    else:
        out = flash_attention(q, k, v, window=window, chunk_q=chunk_q)
        new_cache = {"k": k, "v": v} if make_cache else None
    out = out.reshape(nb, s, h * hd)
    out = lora_linear(out, params["o"], lo.get("o"), scales, n_pack, kcfg=kcfg)
    return out, new_cache


def init_gqa_cache(nb, smax, acfg: AttentionConfig, dtype=torch.bfloat16, device=None):
    kv, hd = acfg.n_kv_heads, acfg.head_dim
    return {
        "k": torch.zeros((nb, smax, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((nb, smax, kv, hd), dtype=dtype, device=device),
    }
