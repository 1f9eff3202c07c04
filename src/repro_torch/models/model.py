"""Top-level model: embedding, decoder stack, LM head (the embedding's
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
  decode_step(...)                           -> (logits (NB,1,V), caches)

The pack dim N is folded into the leading batch: every tensor is (N*B, ...).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, lora_layout
from repro_torch.core.adapter import PackMeta
from repro_torch.models.layers.common import apply_norm, init_linear, init_norm
from repro_torch.models.transformer import (
    apply_stack,
    find_period,
    init_stack,
    init_stack_cache,
    layer_specs,
    make_rope_cache,
)

_NO_LORA = {"blocks": {}, "rest": {}}


def init_model(seed: int, cfg: ModelConfig, meta: Optional[PackMeta],
               dtype=torch.float32, device=None, quant: Optional[str] = None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``:
    embedding N(0, 0.02), linears N(0, 1/d_in), norms 1, biases 0, LoRA A
    N(0, 1/d_in) and B 0, drawn in that order, layer by layer; a tensor the
    config does not have (a tied LM head, "gelu2"'s gate) is not drawn.
    Runs on CUDA unless ``device`` says otherwise.

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
    if not cfg.tie_embeddings:
        base["lm_head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab, False, dtype, device)
    return base, {"decoder": dec_l}


def init_lora(seed: int, cfg: ModelConfig, meta: PackMeta, dtype=torch.float32, device=None):
    """``init_model``'s LoRA tree, bit for bit, without holding its base:
    the generator makes the same draws in the same order, but each base
    leaf is dropped as soon as it is drawn, a layer at a time, and the LM
    head's draws, which follow every A, are not made. At full width this
    holds the embedding's f32 draw where ``init_model`` holds the whole f32
    base."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=device)  # the embedding's
    _, dec_l, _ = init_stack(gen, cfg, layer_specs(cfg), meta, dtype, device, keep_base=False)
    return {"decoder": dec_l}


def lora_zeros(cfg: ModelConfig, meta: PackMeta, dtype=torch.float32, device=None):
    """A LoRA pack tree of zeros in ``init_model``'s layout, without
    building a base model (the serve engine's row pack and template): each
    layer position of the period from its own spec (``lora_layout``: its
    mixer's targets, and on a "dense" FFN the MLP's; "gelu2" has no gate;
    MLA's "q" and "kv" adapt ``q_a`` and ``kv_a``; SSD's "ssm_in" and
    "ssm_out", under ``"ssm"``, adapt ``zx`` and ``out``). A layer with no
    adapter has no entry, as in ``init_stack``."""
    device = resolve_device(device)
    n, r = meta.n, meta.r_bucket
    specs = layer_specs(cfg)
    p = find_period(specs)
    n_blocks, n_rest = divmod(len(specs), p)

    def layer(spec, *lead):
        return {
            grp: {
                nm: {"a": torch.zeros((*lead, n, di, r), dtype=dtype, device=device),
                     "b": torch.zeros((*lead, n, r, do), dtype=dtype, device=device)}
                for nm, (di, do) in projs.items()
            }
            for grp, projs in lora_layout(cfg, spec.mixer, spec.ffn).items()
        }

    def group(n_layers, *lead):
        out = {f"l{i}": layer(specs[i], *lead) for i in range(n_layers)}
        return {k: v for k, v in out.items() if v}

    return {"decoder": {"blocks": group(p, n_blocks) if n_blocks else {},
                        "rest": group(n_rest)}}


# the families whose residual stream is f32 whatever the base's dtype
# (``transformer.apply_layer``): at depth in bf16, the roundings of two
# valid computations -- the kernels and their plain versions -- move an
# SSM's scan state, and an MoE router's choice at near-ties, far enough
# apart to part their logits by more than 5 % of max |logit| (ROADMAP C,
# differences by design); a hybrid has both
F32_STREAM_FAMILIES = ("ssm", "moe", "hybrid")


def _embed(base, tokens, cfg: ModelConfig):
    """The residual stream's start: the embedding's rows, in f32 for a
    family of F32_STREAM_FAMILIES (its stream stays f32 through the
    stack)."""
    x = base["embed"]["w"][tokens]
    return x.float() if cfg.family in F32_STREAM_FAMILIES else x


def _final_norm(base, x, cfg: ModelConfig):
    """The final norm, in the embedding's dtype (the compute dtype)."""
    return apply_norm(base["final_norm"], x, cfg.norm_kind).to(base["embed"]["w"].dtype)


def forward(base, lora, scales, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            n_pack: int = 1, chunk_q: int = 512, make_cache: bool = False, kcfg=None,
            remat: bool = True):
    """batch: {"tokens": (NB, S)}. Returns (hidden (NB, S, d), caches|None,
    aux): aux the MoE layers' summed load-balance loss (an f32 zero
    without one), as the reference's (``repro/models/model.py:103-125``).
    ``remat``: checkpoint each block when grad mode is on (training)."""
    tokens = batch["tokens"]
    x = _embed(base, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, caches, aux = apply_stack(
        base["decoder"], (lora or {}).get("decoder", _NO_LORA), scales, x, cfg,
        layer_specs(cfg), n_pack=n_pack, rope_cache=make_rope_cache(cfg, positions),
        make_cache=make_cache, chunk_q=chunk_q, kcfg=kcfg, remat=remat,
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
    per row), run the stack against ``caches`` (updated in place), return
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
    compute dtype, capacity S). Returns (last-position logits (NB,1,V),
    caches); the aux loss is dropped."""
    hidden, caches, _ = forward(base, lora, scales, batch, cfg, n_pack=n_pack,
                             chunk_q=chunk_q, make_cache=True, kcfg=kcfg)
    return logits(base, hidden[:, -1:, :], cfg), caches
