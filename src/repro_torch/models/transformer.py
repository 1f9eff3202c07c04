"""Decoder stack: pre-norm layers of a mixer -- attention (GQA, or MLA when
the config has a ``kv_lora_rank``) or an SSD block (every layer of an
"ssm" family; a "hybrid" family's layers off its attention pattern) --
and an FFN: a dense MLP, a mixture of experts (a "moe" layer, whose
load-balance aux loss the stack sums) or none (an "ssm" family). Each
layer's parameters and LoRA follow its own spec, so one stack may mix
attention and SSD layers, dense and MoE FFNs (jamba-v0.1-52b). An
encoder-decoder's decoder layers (``LayerSpec.cross``) add a
cross-attention sublayer over the encoder's output between the mixer and
the FFN (whisper-tiny); its encoder is a stack of the same kind run
non-causally (``causal=False``).

Layers are grouped as in the reference: the per-layer spec sequence has a
minimal period p, the L//p repeats are stacked under ``"blocks"`` (every
leaf gains a leading block axis) and the remainder sits under ``"rest"``.
The stack runs as a Python loop over blocks where the reference scans; in
training each block -- a whole period, 8 layers of full jamba's -- is
checkpointed (``torch.utils.checkpoint``) where the reference wraps the
scanned block in ``jax.checkpoint``; the remainder runs unchecked, as in
the reference. (Jamba's first 8 layers alone have a least period of 6: a
block of 6 and a remainder of 2.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import quantize_base_params
from repro_torch.models.layers.attention import (
    apply_gqa,
    apply_mla,
    chunk_start,
    init_gqa,
    init_gqa_cache,
    init_mla,
    init_mla_cache,
)
from repro_torch.models.layers.common import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.layers.moe import apply_moe, init_moe
from repro_torch.models.layers.rope import rope_tables
from repro_torch.models.layers.ssm import (
    apply_ssm,
    apply_ssm_chunk,
    apply_ssm_decode,
    init_ssm,
    init_ssm_cache,
)
from repro_torch.tree import tree_index, tree_map, tree_stack


@dataclass(frozen=True)
class LayerSpec:
    """What may differ between the layers of a stack: the mixer ("attn":
    attention of the config's kind, or "ssm"), the FFN ("dense", "moe" or
    "none"), the sliding window (0: full attention), the rope theta, and
    whether the layer has an encoder-decoder's cross-attention sublayer."""

    mixer: str = "attn"
    ffn: str = "dense"
    window: int = 0
    theta: float = 10_000.0
    cross: bool = False


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """Per-layer specs, as the reference's (``transformer.py:110-133``):
    the mixer and FFN kinds of ``cfg.layer_kinds()`` / ``ffn_kinds()``;
    for an attention layer with ``global_every``, every
    ``global_every``-th layer is global (no window, ``global_rope_theta``)
    and the others local (the window, the base theta); without it every
    attention layer takes ``sliding_window``. An SSM layer has no window.
    Every layer of an encoder-decoder's decoder has ``cross``."""
    a = cfg.attention
    specs = []
    for i, (mixer, ffn) in enumerate(zip(cfg.layer_kinds(), cfg.ffn_kinds())):
        window, theta = (a.sliding_window if mixer == "attn" else 0), a.rope_theta
        if mixer == "attn" and a.global_every and i % a.global_every == a.global_every - 1:
            window, theta = 0, a.global_rope_theta or a.rope_theta
        specs.append(LayerSpec(mixer=mixer, ffn=ffn, window=window, theta=theta,
                               cross=cfg.is_encdec))
    return specs


def find_period(specs: List[LayerSpec]) -> int:
    n = len(specs)
    for p in range(1, n + 1):
        if all(specs[i] == specs[i % p] for i in range(n)):
            return p
    return n


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, meta, dtype, device=None):
    """norm1 and the mixer ("attn" or "ssm"), with ``spec.cross`` the
    cross-attention's GQA projections ("cross", its adapters on the GQA
    targets of ``lora_targets``) and norm_cross, then, for a "dense" FFN,
    the MLP and norm2, for a "moe" FFN the experts (``init_moe``: no LoRA)
    and norm2 ("none": neither)."""
    a = cfg.attention
    params: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm_kind, dtype, device)}
    lora: Dict[str, Any] = {}
    if spec.mixer == "ssm":
        grp = "ssm"
        p, lo = init_ssm(gen, cfg.d_model, cfg.ssm, meta, cfg.lora_targets, dtype, device)
    else:
        grp = "attn"
        init_attn = init_mla if a.is_mla else init_gqa
        p, lo = init_attn(gen, a, cfg.d_model, meta, cfg.lora_targets, dtype, device)
    params[grp] = p
    if lo:
        lora[grp] = lo
    if spec.cross:
        p, lo = init_gqa(gen, a, cfg.d_model, meta, cfg.lora_targets, dtype, device)
        params["cross"] = p
        params["norm_cross"] = init_norm(cfg.d_model, cfg.norm_kind, dtype, device)
        if lo:
            lora["cross"] = lo
    if spec.ffn == "dense":
        p, lo = init_mlp(gen, cfg.d_model, cfg.d_ff, a.use_bias, meta, cfg.lora_targets, dtype,
                         device, kind=cfg.mlp_kind)
        params["mlp"] = p
        params["norm2"] = init_norm(cfg.d_model, cfg.norm_kind, dtype, device)
        if lo:
            lora["mlp"] = lo
    elif spec.ffn == "moe":
        params["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dtype, device)
        params["norm2"] = init_norm(cfg.d_model, cfg.norm_kind, dtype, device)
    return params, lora


def apply_layer(
    params, lora, scales, x, spec: LayerSpec, cfg: ModelConfig, *,
    n_pack: int, rope_cache, cache=None, pos=None, make_cache: bool = False,
    chunk_q: int = 512, kcfg=None, enc_out=None, causal: bool = True,
):
    """Pre-norm residual layer. Returns (x, new_cache or None, aux): aux
    is a "moe" FFN's load-balance loss, None for any other layer.
    ``causal=False``: an encoder's layer, whose attention masks nothing.

    A layer with ``spec.cross`` adds, after the mixer, a pre-norm
    cross-attention sublayer over the encoder's output ``enc_out`` (NB,
    S_enc, d): its K and V are plain biased products of ``enc_out`` (no
    adapter reaches them: the reference's quirk), or, when ``enc_out`` is
    None, the cache's ``"cross_kv"`` (decode); a prefill's or decode's cache
    carries them as ``"cross_kv"`` (the reference's
    ``transformer.py:253-277``). Without either the sublayer is skipped, as
    in the reference.

    An SSM, MoE or hybrid family's residual stream ``x`` is f32
    (``model.F32_STREAM_FAMILIES``): each norm's output is cast to the
    base's dtype, and the residual adds stay f32 (see ``layers/ssm.py``);
    an MoE router reads its norm's f32 output, its experts the cast, and
    its combine sums in f32 (``layers/moe.py``). In a family whose stream
    is the base's dtype the casts do nothing. With a cache a layer takes
    one token per row (decode) or, at a scalar ``pos``, one chunk of a
    chunk-resumable prefill (S > 1; ``model.prefill_chunk``): an SSM layer
    runs ``apply_ssm_decode`` or ``apply_ssm_chunk`` (the reference's
    ``transformer.py:215-218``), attention writes the chunk at ``[pos, pos
    + S)`` and attends the whole cache; either updates the cache in place.
    An MoE layer needs nothing of it: a chunk's expert capacity is set by
    the chunk's own tokens, as in the reference."""
    lo = lora or {}
    h = apply_norm(params["norm1"], x, cfg.norm_kind).to(params["norm1"]["scale"].dtype)
    if spec.mixer == "ssm":
        grp = "ssm"
        kw = dict(scfg=cfg.ssm, n_pack=n_pack, kcfg=kcfg)
        if cache and h.shape[1] == 1:
            y, c = apply_ssm_decode(params["ssm"], lo.get("ssm"), scales, h, cache["ssm"], **kw)
        elif cache:
            chunk_start(pos)  # a chunk's pos is a scalar, as attention's
            y, c = apply_ssm_chunk(params["ssm"], lo.get("ssm"), scales, h, cache["ssm"], **kw)
        else:
            y, c = apply_ssm(params["ssm"], lo.get("ssm"), scales, h, return_state=make_cache,
                             **kw)
    else:
        grp = "attn"
        kw = dict(acfg=cfg.attention, n_pack=n_pack, rope=rope_cache[spec.theta],
                  cache=cache.get("attn") if cache else None, pos=pos, make_cache=make_cache,
                  chunk_q=chunk_q, kcfg=kcfg)
        if cfg.attention.is_mla:
            y, c = apply_mla(params["attn"], lo.get("attn"), scales, h, **kw)
        else:
            y, c = apply_gqa(params["attn"], lo.get("attn"), scales, h, window=spec.window,
                             causal=causal, **kw)
    x = x + y
    new_cache = {grp: c} if c is not None else None
    if spec.cross and (enc_out is not None or (cache and "cross_kv" in cache)):
        h = apply_norm(params["norm_cross"], x, cfg.norm_kind).to(
            params["norm_cross"]["scale"].dtype)
        if enc_out is None:
            ckv = cache["cross_kv"]
        else:
            a, pc = cfg.attention, params["cross"]
            ckv = {}
            for nm in ("k", "v"):
                t = enc_out @ pc[nm]["w"].to(enc_out.dtype)
                if "b" in pc[nm]:
                    t = t + pc[nm]["b"].to(t.dtype)
                ckv[nm] = t.reshape(enc_out.shape[0], -1, a.n_kv_heads, a.head_dim)
        y, _ = apply_gqa(params["cross"], lo.get("cross"), scales, h, acfg=cfg.attention,
                         n_pack=n_pack, rope=None, cross_kv=ckv, chunk_q=chunk_q, kcfg=kcfg)
        if make_cache or cache:
            new_cache = {**(new_cache or {}), "cross_kv": ckv}
        x = x + y
    aux = None
    if spec.ffn == "dense":
        h = apply_norm(params["norm2"], x, cfg.norm_kind).to(params["norm2"]["scale"].dtype)
        x = x + apply_mlp(params["mlp"], lo.get("mlp"), scales, h, n_pack, kcfg=kcfg,
                          kind=cfg.mlp_kind)
    elif spec.ffn == "moe":
        y, aux = apply_moe(params["moe"], apply_norm(params["norm2"], x, cfg.norm_kind), cfg.moe)
        x = x + y
    return x, new_cache, aux


def init_stack(gen, cfg: ModelConfig, specs: List[LayerSpec], meta, dtype, device=None,
               keep_base: bool = True, quant: Optional[str] = None):
    """Returns ({"blocks": stacked, "rest": dict}, same for lora, period).

    Block leaves are allocated stacked once and filled block by block, so a
    full-size model never holds two copies of its weights (a model of one
    block keeps that block's leaves, each given the block axis as a view). ``keep_base=False``
    draws each layer's base weights (so ``gen`` moves as it does for the
    whole model) and drops them at once: the base trees come back empty.
    ``quant`` ("int8" | "nf4") quantizes each layer's eligible projections
    as soon as the layer is drawn (``quantize_base_params`` on the layer),
    so the stacked leaves hold codes and scales and the dense stack never
    exists; every quantized value depends on its own layer only, so the
    result is ``quantize_base_params`` of the dense stack, bit for bit."""
    p = find_period(specs)
    n_blocks, n_rest = divmod(len(specs), p)

    def one(spec_slice):
        bp, bl = {}, {}
        for i, spec in enumerate(spec_slice):
            lp, ll = init_layer(gen, cfg, spec, meta, dtype, device)
            if keep_base:
                bp[f"l{i}"] = quantize_base_params(lp, quant)
            if ll:
                bl[f"l{i}"] = ll
        return bp, bl

    blocks_p: Any = {}
    blocks_l: Any = {}
    for bi in range(n_blocks):
        bp, bl = one(specs[:p])
        if n_blocks == 1:  # the one block, given its axis as a view: no second copy
            blocks_p, blocks_l = tree_map(lambda t: t[None], bp), tree_map(lambda t: t[None], bl)
            break
        if bi == 0:
            alloc = lambda t: torch.empty((n_blocks, *t.shape), dtype=t.dtype, device=t.device)  # noqa: E731
            blocks_p, blocks_l = tree_map(alloc, bp), tree_map(alloc, bl)
        tree_map(lambda dst, src: dst[bi].copy_(src), blocks_p, bp)
        tree_map(lambda dst, src: dst[bi].copy_(src), blocks_l, bl)
    rest_p, rest_l = one(specs[:n_rest])
    return {"blocks": blocks_p, "rest": rest_p}, {"blocks": blocks_l, "rest": rest_l}, p


def apply_stack(
    params, lora, scales, x, cfg: ModelConfig, specs: List[LayerSpec], *,
    n_pack: int, rope_cache, caches=None, pos=None, make_cache: bool = False,
    chunk_q: int = 512, kcfg=None, remat: bool = True, enc_out=None, causal: bool = True,
):
    """Run the whole stack. Returns (x, new_caches, aux): with ``caches``
    given (decode) they are updated in place and returned; with
    ``make_cache`` (prefill) the per-layer k/v come back in the cache tree
    layout; aux is the sum of the layers' MoE aux losses (an f32 zero
    without an MoE layer). With ``remat`` and grad mode on, each block
    keeps only its input for the backward and recomputes the rest
    (``transformer.py:403`` of the reference) and returns its aux beside
    its output; the kernels and the MoE dispatch are deterministic, so the
    recompute equals the forward. ``enc_out``: an encoder's output, which
    each cross-attention sublayer reads (an argument of each checkpointed
    block, so its gradient flows back through the recompute);
    ``causal=False``: an encoder's stack."""
    p = find_period(specs)
    n_blocks, n_rest = divmod(len(specs), p)
    kw = dict(cfg=cfg, n_pack=n_pack, rope_cache=rope_cache, pos=pos,
              make_cache=make_cache, chunk_q=chunk_q, kcfg=kcfg, causal=causal)
    lora = lora or {}

    def add(total, a):
        return a if total is None else total if a is None else total + a

    def run(x, bp, bl, bc, n_layers, enc_out=enc_out):
        new_c, aux = {}, None
        for i in range(n_layers):
            x, c, a = apply_layer(bp[f"l{i}"], (bl or {}).get(f"l{i}"), scales, x, specs[i],
                                  cache=(bc or {}).get(f"l{i}"), enc_out=enc_out, **kw)
            if c is not None:
                new_c[f"l{i}"] = c
            aux = add(aux, a)
        return x, new_c, aux

    checkpointed = remat and torch.is_grad_enabled() and caches is None and not make_cache
    block_caches, aux = [], None
    for bi in range(n_blocks):
        bp = tree_index(params["blocks"], bi)
        bl = tree_index(lora["blocks"], bi) if lora.get("blocks") else None
        bc = tree_index(caches["blocks"], bi) if caches is not None else None
        if checkpointed:
            # no RNG state to stash: the stack draws no random numbers, and
            # reading the CUDA RNG state cannot be captured in a CUDA graph
            x, a = checkpoint(lambda h, e, bp=bp, bl=bl: run(h, bp, bl, None, p, e)[::2], x,
                              enc_out, use_reentrant=False, preserve_rng_state=False)
            aux = add(aux, a)
            continue
        x, c, a = run(x, bp, bl, bc, p)
        block_caches.append(c)
        aux = add(aux, a)
    x, rest_c, a = run(x, params["rest"], lora.get("rest"), caches["rest"] if caches else None,
                       n_rest)
    aux = add(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is not None:
        return x, caches, aux
    if make_cache:
        return x, {"blocks": tree_stack(block_caches) if n_blocks else None, "rest": rest_c}, aux
    return x, None, aux


def make_rope_cache(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin tables per distinct rope theta of the stack's attention
    layers (``rope_theta`` alone when it has none, as the reference), over
    the heads' rotated width: ``head_dim``, or MLA's ``qk_rope_head_dim``."""
    a = cfg.attention
    dim = a.qk_rope_head_dim if a.is_mla else a.head_dim
    thetas = {s.theta for s in layer_specs(cfg) if s.mixer == "attn"} or {a.rope_theta}
    return {t: rope_tables(positions, dim, t) for t in thetas}


def init_stack_cache(cfg, specs, nb: int, smax: int, dtype=torch.bfloat16, device=None):
    """Cache tree matching ``apply_stack(caches=...)``: k/v (NB, Smax, KV,
    D) per attention layer, or MLA's latent ckv (NB, Smax, kvlr) and k_rope
    (NB, Smax, dr), in ``dtype``; an SSM layer's conv window (NB, K-1, C)
    and state (NB, H, P, N), in f32 whatever ``dtype`` (a rounded state
    would drift at every step); a cross-attention layer's ``"cross_kv"``
    k/v (NB, S_enc, KV, D) over the encoder's ``encoder_seq_len`` frames,
    in ``dtype``. A stacked block's leaves lead with the block axis."""
    p = find_period(specs)
    n_blocks, n_rest = divmod(len(specs), p)
    a = cfg.attention
    meta = torch.device("meta")

    def one(spec, *lead):  # the leaves' shapes from a cache on the meta device
        if spec.mixer == "ssm":
            grp, like = "ssm", init_ssm_cache(nb, cfg.d_model, cfg.ssm, torch.float32, meta)
        else:
            init = init_mla_cache if a.is_mla else init_gqa_cache
            grp, like = "attn", init(nb, smax, a, dtype, meta)
        out = {grp: like}
        if spec.cross:
            out["cross_kv"] = init_gqa_cache(nb, cfg.encoder_seq_len, a, dtype, meta)
        return {g: {k: torch.zeros((*lead, *t.shape), dtype=t.dtype, device=device)
                    for k, t in c.items()} for g, c in out.items()}

    return {
        "blocks": {f"l{i}": one(specs[i], n_blocks) for i in range(p)} if n_blocks else None,
        "rest": {f"l{i}": one(specs[i]) for i in range(n_rest)},
    }
