"""Top-level model: embedding (after a VLM's projected patch prefix), an
encoder-decoder's encoder, the decoder stack, LM head (the embedding's
transpose when the config ties them); prefill and decode.

Public API (functional; parameters are nested dicts of tensors laid out as
the reference's pytrees, so ``repro_torch.bridge`` carries them across
unchanged):

  init_model(seed, cfg, meta, dtype, device, quant) -> (base_params, lora_params)
  init_lora(seed, cfg, meta, dtype, device)  -> init_model's lora_params alone
  forward(base, lora, scales, batch, cfg, .) -> (hidden (NB,S,d), caches|None, aux)
  logits(base, hidden, cfg)                  -> (NB,S,V)
  init_caches(cfg, nb, smax)                 -> cache tree
  prefill(...)                               -> (last logits (NB,1,V), caches)
  prefill_chunk(...)                         -> (last logits (NB,1,V), caches)
  decode_step(...)                           -> (logits (NB,1,V), caches)

The pack dim N is folded into the leading batch: every tensor is (N*B, ...).
The modality front ends are stubs, as in the reference: an "audio" batch
(whisper) carries precomputed frame embeddings ("frames": (NB, S_enc, d)),
which a non-causal encoder stack and ``enc_norm`` turn into the decoder's
cross-attention input; a "vlm" batch (internvl2) carries precomputed patch
embeddings ("patches": (NB, P, d)), which ``patch_proj`` projects and puts
before the tokens' embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ENCODER_LAYER, ModelConfig, lora_layout
from repro_torch.core.adapter import PackMeta
from repro_torch.models.layers.attention import chunk_start
from repro_torch.models.layers.common import apply_norm, init_linear, init_norm
from repro_torch.models.transformer import (
    LayerSpec,
    apply_stack,
    find_period,
    init_stack,
    init_stack_cache,
    layer_specs,
    make_rope_cache,
)

_NO_LORA = {"blocks": {}, "rest": {}}


def encoder_specs(cfg: ModelConfig):
    """An encoder-decoder's encoder layers: GQA (run non-causally) and a
    dense MLP, at the base rope theta, with no cross-attention; none for a
    decoder alone."""
    mixer, ffn = ENCODER_LAYER
    return [LayerSpec(mixer=mixer, ffn=ffn, theta=cfg.attention.rope_theta)
            for _ in range(cfg.encoder_layers)]


def init_model(seed: int, cfg: ModelConfig, meta: Optional[PackMeta],
               dtype=torch.float32, device=None, quant: Optional[str] = None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``:
    embedding N(0, 0.02), linears N(0, 1/d_in), norms 1, biases 0, LoRA A
    N(0, 1/d_in) and B 0, drawn in that order, layer by layer: the
    embedding, the decoder, an encoder-decoder's encoder (and ``enc_norm``),
    a VLM's ``patch_proj`` (biased), then the LM head; a tensor the config
    does not have (a tied LM head, "gelu2"'s gate) is not drawn. Runs on
    CUDA unless ``device`` says otherwise.

    ``quant`` ("int8" | "nf4"; None or "none": dense) builds a quantized
    frozen base layer by layer: each layer's projections are drawn in
    ``dtype`` and quantized before the next layer is drawn, into stacked
    codes and scales allocated once. The tree is
    ``quantize_base_params(init_model(seed, cfg, meta, dtype), quant)`` bit
    for bit (the same draws in the same order), and the LoRA tree is
    unchanged, but the dense stack never exists: at full size the peak is
    the embedding's f32 draw or the quantized tree plus one layer's
    temporaries (command-r-35b, counted from its shapes: 60.6 GB as a bf16
    tree, 32.4 GB as int8 codes beside its bf16 embedding)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=device)
    base: Dict[str, Any] = {
        "embed": {"w": emb.mul_(0.02).to(dtype)},
        "final_norm": init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
    }
    del emb
    dec_p, dec_l, _ = init_stack(gen, cfg, layer_specs(cfg), meta, dtype, device, quant=quant)
    base["decoder"] = dec_p
    lora = {"decoder": dec_l}
    if cfg.is_encdec:
        base["encoder"], lora["encoder"], _ = init_stack(gen, cfg, encoder_specs(cfg), meta, dtype,
                                                         device, quant=quant)
        base["enc_norm"] = init_norm(cfg.d_model, cfg.norm_kind, dtype, device)
    if cfg.n_patch_tokens:
        base["patch_proj"] = init_linear(gen, cfg.d_model, cfg.d_model, True, dtype, device)
    if not cfg.tie_embeddings:
        base["lm_head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab, False, dtype, device)
    return base, lora


def init_lora(seed: int, cfg: ModelConfig, meta: PackMeta, dtype=torch.float32, device=None):
    """``init_model``'s LoRA tree, bit for bit, without holding its base:
    the generator makes the same draws in the same order, but each base
    leaf is dropped as soon as it is drawn, a layer at a time, and the
    ``patch_proj`` and LM head draws, which follow every A, are not made.
    At full width this holds the embedding's f32 draw where ``init_model``
    holds the whole f32 base."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=device)  # the embedding's
    _, dec_l, _ = init_stack(gen, cfg, layer_specs(cfg), meta, dtype, device, keep_base=False)
    lora = {"decoder": dec_l}
    if cfg.is_encdec:
        _, lora["encoder"], _ = init_stack(gen, cfg, encoder_specs(cfg), meta, dtype, device,
                                           keep_base=False)
    return lora


def lora_zeros(cfg: ModelConfig, meta: PackMeta, dtype=torch.float32, device=None):
    """A LoRA pack tree of zeros in ``init_model``'s layout, without
    building a base model (the serve engine's row pack and template): each
    layer position of the period from its own spec (``lora_layout``: its
    mixer's targets, and on a "dense" FFN the MLP's; "gelu2" has no gate;
    MLA's "q" and "kv" adapt ``q_a`` and ``kv_a``; SSD's "ssm_in" and
    "ssm_out", under ``"ssm"``, adapt ``zx`` and ``out``; an
    encoder-decoder's decoder layers add the "cross" group, and its
    ``"encoder"`` subtree holds its own layers'). A layer with no adapter
    has no entry, as in ``init_stack``."""
    device = resolve_device(device)
    n, r = meta.n, meta.r_bucket

    def layer(spec, *lead):
        return {
            grp: {
                nm: {"a": torch.zeros((*lead, n, di, r), dtype=dtype, device=device),
                     "b": torch.zeros((*lead, n, r, do), dtype=dtype, device=device)}
                for nm, (di, do) in projs.items()
            }
            for grp, projs in lora_layout(cfg, spec.mixer, spec.ffn, spec.cross).items()
        }

    def stack(specs):
        p = find_period(specs)
        n_blocks, n_rest = divmod(len(specs), p)

        def group(n_layers, *lead):
            out = {f"l{i}": layer(specs[i], *lead) for i in range(n_layers)}
            return {k: v for k, v in out.items() if v}

        return {"blocks": group(p, n_blocks) if n_blocks else {}, "rest": group(n_rest)}

    out = {"decoder": stack(layer_specs(cfg))}
    if cfg.is_encdec:
        out["encoder"] = stack(encoder_specs(cfg))
    return out


# the families whose residual stream is f32 whatever the base's dtype
# (``transformer.apply_layer``): at depth in bf16, the roundings of two
# valid computations -- the kernels and their plain versions -- move an
# SSM's scan state, and an MoE router's choice at near-ties, far enough
# apart to part their logits by more than 5 % of max |logit| (ROADMAP C,
# differences by design); a hybrid has both
F32_STREAM_FAMILIES = ("ssm", "moe", "hybrid")


def _embed(base, tokens, cfg: ModelConfig, batch=None):
    """The residual stream's start: the embedding's rows, in f32 for a
    family of F32_STREAM_FAMILIES (its stream stays f32 through the
    stack); a VLM's batch with ``"patches"`` (NB, P, d) puts them, through
    the biased ``patch_proj``, before the tokens (the reference's
    ``model.py:66-72``)."""
    x = base["embed"]["w"][tokens]
    if cfg.n_patch_tokens and batch is not None and "patches" in batch:
        pp = base["patch_proj"]
        pe = batch["patches"].to(x.dtype) @ pp["w"].to(x.dtype) + pp["b"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x.float() if cfg.family in F32_STREAM_FAMILIES else x


def _encode(base, lora, scales, frames, cfg: ModelConfig, *, n_pack: int, chunk_q: int, kcfg,
            remat: bool = True):
    """An encoder-decoder's encoder over precomputed frame embeddings (NB,
    S_enc, d), in the embedding's dtype: its stack, non-causal, at rope
    positions 0..S_enc-1, then ``enc_norm`` (the reference's
    ``model.py:75-87``)."""
    frames = frames.to(base["embed"]["w"].dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)
    h, _, _ = apply_stack(
        base["encoder"], (lora or {}).get("encoder", _NO_LORA), scales, frames, cfg,
        encoder_specs(cfg), n_pack=n_pack, rope_cache=make_rope_cache(cfg, positions),
        chunk_q=chunk_q, kcfg=kcfg, remat=remat, causal=False,
    )
    return apply_norm(base["enc_norm"], h, cfg.norm_kind)


def _final_norm(base, x, cfg: ModelConfig):
    """The final norm, in the embedding's dtype (the compute dtype)."""
    return apply_norm(base["final_norm"], x, cfg.norm_kind).to(base["embed"]["w"].dtype)


def forward(base, lora, scales, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            n_pack: int = 1, chunk_q: int = 512, make_cache: bool = False, kcfg=None,
            remat: bool = True):
    """batch: {"tokens": (NB, S)[, "frames": (NB, S_enc, d)][, "patches":
    (NB, P, d)]}. Returns (hidden (NB, S_total, d), caches|None, aux):
    S_total = P + S with a patch prefix; aux the MoE layers' summed
    load-balance loss (an f32 zero without one), as the reference's
    (``repro/models/model.py:90-125``). An encoder-decoder runs its encoder
    over the frames first; its decoder's cross-attention reads the
    encoder's output. ``remat``: checkpoint each block when grad mode is on
    (training)."""
    x = _embed(base, batch["tokens"], cfg, batch)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encode(base, lora, scales, batch["frames"], cfg, n_pack=n_pack,
                          chunk_q=chunk_q, kcfg=kcfg, remat=remat)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, aux = apply_stack(
        base["decoder"], (lora or {}).get("decoder", _NO_LORA), scales, x, cfg,
        layer_specs(cfg), n_pack=n_pack, rope_cache=make_rope_cache(cfg, positions),
        make_cache=make_cache, chunk_q=chunk_q, kcfg=kcfg, remat=remat, enc_out=enc_out,
    )
    return _final_norm(base, x, cfg), caches, aux


def unembed_w(base, cfg: ModelConfig):
    """The LM head's (d, V) weight: with tied embeddings the embedding's
    transpose, a view (no copy of the (V, d) matrix)."""
    if cfg.tie_embeddings:
        return base["embed"]["w"].T
    return base["lm_head"]["w"]


def logits(base, hidden, cfg: ModelConfig):
    """(NB, S, padded_vocab); padded columns masked to -1e30."""
    lg = hidden @ unembed_w(base, cfg).to(hidden.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        lg[..., cfg.vocab_size:] = -1e30
    return lg


def init_caches(cfg: ModelConfig, nb: int, smax: int, dtype=torch.bfloat16, device=None):
    return init_stack_cache(cfg, layer_specs(cfg), nb, smax, dtype, resolve_device(device))


def decode_step(base, lora, scales, token: torch.Tensor, caches, pos, cfg: ModelConfig, *,
                n_pack: int = 1, kcfg=None):
    """One serve step: embed ``token`` (NB, 1) at ``pos`` (() shared, or (NB,)
    per row), run the stack against ``caches`` (updated in place; an
    encoder-decoder's cross-attention reads its ``"cross_kv"``), return
    (logits (NB, 1, V), caches)."""
    x = _embed(base, token, cfg)
    # scalar pos -> shared (1, D/2) tables; vector pos -> per-row (NB, 1, D/2)
    rc = make_rope_cache(cfg, pos[None] if pos.dim() == 0 else pos[:, None])
    x, caches, _ = apply_stack(
        base["decoder"], (lora or {}).get("decoder", _NO_LORA), scales, x, cfg,
        layer_specs(cfg), n_pack=n_pack, rope_cache=rc, caches=caches, pos=pos, kcfg=kcfg,
    )
    return logits(base, _final_norm(base, x, cfg), cfg), caches


def prefill(base, lora, scales, batch, cfg: ModelConfig, *,
            n_pack: int = 1, chunk_q: int = 512, kcfg=None):
    """Full-sequence forward that also returns the k/v caches (in the
    compute dtype, capacity S_total: a VLM's patch positions included) and
    an encoder-decoder's ``"cross_kv"``; ``batch`` as ``forward``'s.
    Returns (last-position logits (NB,1,V), caches); the aux loss is
    dropped."""
    hidden, caches, _ = forward(base, lora, scales, batch, cfg, n_pack=n_pack,
                             chunk_q=chunk_q, make_cache=True, kcfg=kcfg)
    return logits(base, hidden[:, -1:, :], cfg), caches


def prefill_chunk(base, lora, scales, tokens: torch.Tensor, caches, pos: int, cfg: ModelConfig, *,
                  n_pack: int = 1, kcfg=None):
    """One chunk of a chunk-resumable prefill (the reference's
    ``model.py:200-237``): embed ``tokens`` (NB, C) at positions ``pos +
    arange(C)`` (``pos`` a Python int: the caller's loop knows it, so no
    layer reads it back from the card), run the stack against the
    partly filled ``caches`` (updated in place: attention writes the
    chunk's k/v at ``pos`` and attends the whole cache under its masks,
    an SSM layer replays its conv window and resumes its state), and
    return (last-position logits (NB, 1, V), caches).

    Over consecutive chunks into caches of capacity S (the prompt's
    length) this reproduces ``prefill``'s logits and caches; on an SSM
    stack every ``pos`` must be a multiple of ``cfg.ssm.chunk_size`` for
    that. An encoder-decoder raises ``ValueError``: its prefill is one
    shot, as a VLM's with its patch prefix is (the engine keeps both so)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder's prefill is one shot; "
                         "prefill_chunk does not take it")
    pos = chunk_start(pos)
    x = _embed(base, tokens, cfg)
    positions = torch.arange(pos, pos + tokens.shape[1], device=tokens.device)
    x, caches, _ = apply_stack(
        base["decoder"], (lora or {}).get("decoder", _NO_LORA), scales, x, cfg,
        layer_specs(cfg), n_pack=n_pack, rope_cache=make_rope_cache(cfg, positions),
        caches=caches, kcfg=kcfg,
        # a one-token chunk takes the decode step's formulas, which index by a tensor
        pos=positions[0] if tokens.shape[1] == 1 else pos,
    )
    return logits(base, _final_norm(base, x, cfg)[:, -1:, :], cfg), caches
