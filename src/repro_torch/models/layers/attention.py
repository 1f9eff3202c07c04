"""Attention, GQA (with sliding window; non-causal for an encoder; cross
attention over an encoder's output) and MLA: prefill over query chunks,
cached decode.

Attention is not a kernel of the reference (it is plain jnp there), so it
is plain PyTorch here: scores in f32, masked with -1e30, softmax in f32,
probabilities cast to the value type — as the reference rounds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MLA_TARGETS, AttentionConfig, attn_projections
from repro_torch.core.adapter import init_lora_pair
from repro_torch.core.packed_lora import lora_linear
from repro_torch.models.layers.common import apply_norm, init_linear
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


def _attend_chunk(q, k, v, qpos, kpos, scale, window: int = 0, causal: bool = True):
    """Attention of a query chunk: causal (``causal=False``: every key),
    within ``window`` positions when it is set. q: (B, cq, H, D); k/v: (B,
    Sk, KV, D / Dv); returns (B, cq, H, Dv)."""
    b, cq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, cq, kv, h // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = (kpos[None, :] <= qpos[:, None]) if causal else None
    if window:
        band = (qpos[:, None] - kpos[None, :]) < window
        mask = band if mask is None else mask & band
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, cq, h, v.shape[-1])


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, chunk_q: int = 512,
                    scale: Optional[float] = None):
    """Attention over query chunks of ``chunk_q`` (scores never exceed
    chunk_q x Sk), causal unless ``causal=False`` (an encoder's, or a
    cross-attention's queries over another sequence's keys: nothing is
    masked, and the last chunk may be ragged: 1,500 frames are two chunks
    of 512 and one of 476). q: (B, Sq, H, D); k/v: (B, Sk, KV, D / Dv), the
    output's head width V's (MLA's v heads are narrower than its q/k). With a
    ``window`` and more than one chunk, each chunk reads only the K/V band
    its queries reach, [c0 - window + 1, c0 + chunk_q) (the reference's
    band slice, ``attention.py:84-104``): local layers cost
    O(Sq x (window + chunk_q)), not O(Sq^2)."""
    sq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    kpos = torch.arange(max(sq, k.shape[1]), device=q.device)
    if sq <= chunk_q:
        return _attend_chunk(q, k, v, kpos[:sq], kpos[:k.shape[1]], scale, window, causal)
    outs = []
    for c0 in range(0, sq, chunk_q):
        qc = q[:, c0 : c0 + chunk_q]
        qpos = kpos[c0 : c0 + qc.shape[1]]
        band = window and causal
        lo, hi = (max(0, c0 - window + 1), c0 + qc.shape[1]) if band else (0, k.shape[1])
        outs.append(_attend_chunk(qc, k[:, lo:hi], v[:, lo:hi], qpos, kpos[lo:hi], scale, window,
                                  causal))
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


def chunk_start(pos) -> int:
    """The first position of a prefill chunk (S > 1 against a cache): a
    scalar, as the reference asserts (``attention.py:212-213``); a (NB,)
    vector of per-row positions takes one token per row."""
    if isinstance(pos, torch.Tensor) and pos.dim() != 0:
        raise ValueError("a vector pos takes one token per row; a prefill chunk (S > 1) "
                         "takes a scalar pos")
    return int(pos)


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
    causal: bool = True,
    cache: Optional[dict] = None,
    pos=None,
    cross_kv: Optional[dict] = None,
    make_cache: bool = False,
    chunk_q: int = 512,
    kcfg=None,
):
    """x: (NB, S, d). Returns (out, cache or None). ``window``: the layer's
    sliding window (0: full attention); ``causal=False``: an encoder's
    attention, masking nothing.

    With a cache (single-token decode) this step's k/v are written into it
    in place at ``pos`` — a (NB,) vector writes each row at its own slot —
    and the updated cache is returned. A cached call with S > 1 is one
    chunk of a chunk-resumable prefill (``model.prefill_chunk``): ``pos`` a
    scalar (a Python int, or a 0-d tensor read once on the host), the
    chunk's k/v written in place at ``[pos, pos + S)``, and its queries, at
    ``pos + arange(S)``, attend the whole cache under the layer's causal
    mask and ``window`` (``_attend_chunk``; the reference's
    ``attention.py:208-233``), the cache read in the compute dtype, as the
    one-shot path's k/v are. With capacity S_total (the prompt's length)
    the chunks reproduce the one-shot prefill. With ``cross_kv`` ({"k",
    "v"}: (NB, S_enc, KV, D), an encoder's output through the cross
    sublayer's plain k/v products) the queries, without rope, attend those keys and values
    unmasked, and no cache is written: the reference's cross-attention path
    (``attention.py:193-198``)."""
    lo = lora or {}
    nb, s, _ = x.shape
    h, kvh, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    q = lora_linear(x, params["q"], lo.get("q"), scales, n_pack, kcfg=kcfg).reshape(nb, s, h, hd)
    if cross_kv is not None:
        out = flash_attention(q, cross_kv["k"], cross_kv["v"], causal=False, chunk_q=chunk_q)
        out = out.reshape(nb, s, h * hd)
        return lora_linear(out, params["o"], lo.get("o"), scales, n_pack, kcfg=kcfg), None
    k = lora_linear(x, params["k"], lo.get("k"), scales, n_pack, kcfg=kcfg).reshape(nb, s, kvh, hd)
    v = lora_linear(x, params["v"], lo.get("v"), scales, n_pack, kcfg=kcfg).reshape(nb, s, kvh, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if s == 1:
            rows = torch.arange(nb, device=x.device)
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
            out = decode_attention(q, ck, cv, pos, window=window)
        else:
            p0 = chunk_start(pos)
            ck[:, p0 : p0 + s] = k.to(ck.dtype)
            cv[:, p0 : p0 + s] = v.to(cv.dtype)
            kpos = torch.arange(ck.shape[1], device=x.device)
            out = _attend_chunk(q, ck.to(q.dtype), cv.to(q.dtype), kpos[p0 : p0 + s], kpos,
                                hd ** -0.5, window, causal)
        new_cache = cache
    else:
        out = flash_attention(q, k, v, causal=causal, window=window, chunk_q=chunk_q)
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


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-V2 style), the reference's ``attention.py:259-417``
# ---------------------------------------------------------------------------

def init_mla(gen, acfg: AttentionConfig, d_model, meta, targets, dtype=torch.float32, device=None):
    """The six MLA projections (no bias) and the two latent RMSNorms, then
    LoRA pairs on ``q_a``, ``kv_a`` and ``o`` for the targets "q", "kv"
    and "o"."""
    shapes = attn_projections(acfg, d_model)
    params = {nm: init_linear(gen, *shapes[nm], False, dtype, device) for nm in shapes}
    params["q_norm"] = {"scale": torch.ones((acfg.q_lora_rank,), dtype=dtype, device=device)}
    params["kv_norm"] = {"scale": torch.ones((acfg.kv_lora_rank,), dtype=dtype, device=device)}
    lora = {}
    if meta is not None:
        for t, nm in MLA_TARGETS.items():
            if t in targets:
                lora[nm] = init_lora_pair(gen, meta, *shapes[nm], dtype, device)
    return params, lora


def _mla_qkv(params, lo, scales, x, n_pack, acfg, rope, kcfg=None):
    """The projections shared by every MLA path: q_nope (NB, S, H, dn),
    q_rope (NB, S, H, dr), the normed latent ckv (NB, S, kvlr) and k_rope
    (NB, S, 1, dr). ``q_b`` carries no adapter: a plain ``x @ W``."""
    nb, s, _ = x.shape
    h, dn, dr = acfg.n_heads, acfg.qk_nope_head_dim, acfg.qk_rope_head_dim
    cos, sin = rope
    cq = lora_linear(x, params["q_a"], lo.get("q_a"), scales, n_pack, kcfg=kcfg)
    cq = apply_norm(params["q_norm"], cq, "rmsnorm")
    q = lora_linear(cq, params["q_b"], None, scales, n_pack, kcfg=kcfg).reshape(nb, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    ckv_full = lora_linear(x, params["kv_a"], lo.get("kv_a"), scales, n_pack, kcfg=kcfg)
    ckv = apply_norm(params["kv_norm"], ckv_full[..., : acfg.kv_lora_rank], "rmsnorm")
    k_rope = apply_rope(ckv_full[..., acfg.kv_lora_rank :][:, :, None, :], cos, sin)
    return q_nope, q_rope, ckv, k_rope


def _mla_expand(params, acfg: AttentionConfig, q_nope, q_rope, ckv, k_rope):
    """Train's and a prefill's per-head operands from the latent: Q = [q_nope
    | q_rope], K = [ckv @ kv_b_k | k_rope, shared by every head], V = ckv @
    kv_b_v. ckv: (NB, Sk, kvlr); k_rope: (NB, Sk, dr)."""
    nb, sk, _ = ckv.shape
    h, dn, dv = acfg.n_heads, acfg.qk_nope_head_dim, acfg.v_head_dim
    k_nope = (ckv @ params["kv_b_k"]["w"].to(ckv.dtype)).reshape(nb, sk, h, dn)
    v = (ckv @ params["kv_b_v"]["w"].to(ckv.dtype)).reshape(nb, sk, h, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(nb, sk, h, k_rope.shape[-1])], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def apply_mla(
    params, lora, scales, x, *,
    acfg: AttentionConfig,
    n_pack: int,
    rope: Tuple[torch.Tensor, torch.Tensor],
    cache: Optional[dict] = None,
    pos=None,
    make_cache: bool = False,
    chunk_q: int = 512,
    kcfg=None,
):
    """x: (NB, S, d). Returns (out, cache or None); the softmax scale is
    (dn + dr)^-0.5.

    Train and prefill expand the latent ckv through ``kv_b_k`` / ``kv_b_v``
    into per-head K (nope + the shared rope part) and V, and attend over
    query chunks. With a cache (single-token decode) this step's ckv and
    k_rope are written into it in place at ``pos`` (a (NB,) vector writes
    each row at its own slot) and the step attends in the latent space:
    W_uk folded into q, scores against the compressed cache, the context
    expanded through W_uv (the absorbed decode). A cached call with S > 1
    (a prefill chunk at a scalar ``pos``, as GQA's) writes the chunk's ckv
    and k_rope at ``[pos, pos + S)``, then expands the *whole* latent cache,
    read in the compute dtype, through ``kv_b_k`` / ``kv_b_v`` exactly as
    the prefill branch does and attends with ``_attend_chunk`` (the
    reference's ``attention.py:355-381``): the absorbed form is not bitwise
    the expanded one, so it stays for S = 1."""
    lo = lora or {}
    nb, s, _ = x.shape
    h = acfg.n_heads
    dn, dr, dv = acfg.qk_nope_head_dim, acfg.qk_rope_head_dim, acfg.v_head_dim
    scale = (dn + dr) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, lo, scales, x, n_pack, acfg, rope, kcfg)
    if cache is None:
        q, k, v = _mla_expand(params, acfg, q_nope, q_rope, ckv, k_rope[:, :, 0, :])
        out = flash_attention(q, k, v, chunk_q=chunk_q, scale=scale)
        new_cache = {"ckv": ckv, "k_rope": k_rope[:, :, 0, :]} if make_cache else None
    elif s > 1:
        ckv_c, kr_c = cache["ckv"], cache["k_rope"]
        p0 = chunk_start(pos)
        ckv_c[:, p0 : p0 + s] = ckv.to(ckv_c.dtype)
        kr_c[:, p0 : p0 + s] = k_rope[:, :, 0].to(kr_c.dtype)
        q, k, v = _mla_expand(params, acfg, q_nope, q_rope, ckv_c.to(ckv.dtype),
                              kr_c.to(k_rope.dtype))
        kpos = torch.arange(ckv_c.shape[1], device=x.device)
        out = _attend_chunk(q, k, v, kpos[p0 : p0 + s], kpos, scale)
        new_cache = cache
    else:
        ckv_c, kr_c = cache["ckv"], cache["k_rope"]
        rows = torch.arange(nb, device=x.device)
        ckv_c[rows, pos] = ckv[:, 0].to(ckv_c.dtype)
        kr_c[rows, pos] = k_rope[:, 0, 0].to(kr_c.dtype)
        wk = params["kv_b_k"]["w"].reshape(acfg.kv_lora_rank, h, dn)
        q_abs = torch.einsum("bshd,rhd->bhr", q_nope, wk.to(q_nope.dtype))
        s1 = torch.einsum("bhr,bkr->bhk", q_abs.float(), ckv_c.to(q_abs.dtype).float())
        s2 = torch.einsum("bshd,bkd->bhk", q_rope.float(), kr_c.to(q_rope.dtype).float())
        scores = (s1 + s2) * scale
        kpos = torch.arange(ckv_c.shape[1], device=x.device)
        mask = kpos[None, :] <= pos.reshape(-1, 1)  # (NB or 1, Smax)
        scores = torch.where(mask[:, None, :], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhk,bkr->bhr", p.to(ckv_c.dtype), ckv_c)
        wv = params["kv_b_v"]["w"].reshape(acfg.kv_lora_rank, h, dv)
        out = torch.einsum("bhr,rhd->bhd", ctx, wv.to(ctx.dtype))[:, None]
        new_cache = cache
    out = out.reshape(nb, s, h * dv)
    out = lora_linear(out, params["o"], lo.get("o"), scales, n_pack, kcfg=kcfg)
    return out, new_cache


def init_mla_cache(nb, smax, acfg: AttentionConfig, dtype=torch.bfloat16, device=None):
    return {
        "ckv": torch.zeros((nb, smax, acfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((nb, smax, acfg.qk_rope_head_dim), dtype=dtype, device=device),
    }
