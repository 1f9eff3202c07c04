"""Model and LoRA configurations for the PyTorch port.

The port keeps its own copy of the reference's configuration dataclasses
(``repro.configs.base``), cut to what the ported families need (GQA:
qwen25-7b, starcoder2-7b, gemma3-1b, command-r-35b; MLA: minicpm3-4b;
SSD: mamba2-370m; MoE: qwen3-moe-30b-a3b, grok-1-314b; the attention/SSD
hybrid with MoE: jamba-v0.1-52b; the encoder-decoder: whisper-tiny; the
patch-prefix VLM: internvl2-1b): the port imports nothing of the JAX
package.
Field names and defaults match the reference, so a test can build the same
configuration on both sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


# the MLP's projections per ``mlp_kind``, in the order they are drawn:
# "gelu2" (the classic up -> GELU -> down) has no gate
MLP_PROJECTIONS = {"swiglu": ("gate", "up", "down"), "gelu": ("gate", "up", "down"),
                   "gelu2": ("up", "down")}
# the LoRA target name -> the MLA projection it adapts (q_b, kv_b_k and
# kv_b_v carry no adapter)
MLA_TARGETS = {"q": "q_a", "kv": "kv_a", "o": "o"}
# the LoRA target name -> the SSD projection it adapts (bc and dt carry no
# adapter)
SSM_TARGETS = {"ssm_in": "zx", "ssm_out": "out"}
# an encoder-decoder's encoder layer: (mixer, ffn) of non-causal GQA over
# the frames and a dense MLP, with no cross-attention group
ENCODER_LAYER = ("attn", "dense")
# the cross-attention group's adapters that no loss reads: its K and V are
# plain products of the encoder's output (the reference's
# ``transformer.py:258-269``), so an adapter there gets a zero gradient
CROSS_UNREAD = ("k", "v")


@dataclass(frozen=True)
class AttentionConfig:
    """Grouped-query attention with the reference's sliding window, or
    multi-head latent attention (MiniCPM3 / DeepSeek-V2) when
    ``kv_lora_rank`` > 0."""

    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10_000.0
    use_bias: bool = False
    # sliding-window attention (gemma3's local layers); 0 = full
    sliding_window: int = 0
    # local:global layer pattern: every ``global_every``-th layer is global
    # (no window, ``global_rope_theta``); 0 = every layer uses the window
    global_every: int = 0
    global_rope_theta: float = 0.0
    # multi-head latent attention: q and kv through low-rank projections
    # (q_a -> q_b, kv_a -> kv_b_k / kv_b_v), q/k heads of nope + rope
    # widths, v heads of ``v_head_dim``
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0


def _fields_equal(a, b) -> bool:
    """Field for field, against the reference's config of the same class
    name too: a port config and the JAX package's compare equal when their
    values do."""
    if type(b).__name__ != type(a).__name__:
        return NotImplemented
    return all(getattr(a, f.name) == getattr(b, f.name, None) for f in dataclasses.fields(a))


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration [arXiv:2405.21060]; single-group
    B/C, as the reference runs it."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    @property
    def enabled(self) -> bool:
        return self.d_state > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def __eq__(self, other) -> bool:
        return _fields_equal(self, other)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (the reference's fields and defaults):
    ``n_experts`` SwiGLU experts of hidden size ``d_expert``, ``top_k``
    routed per token, on every ``moe_every``-th layer. ``impl``: "dense"
    (every expert on every token, gate-weighted: the exact oracle) or "ep"
    (a capacity-bounded sort-based dispatch; ``capacity_factor`` sets the
    slots per expert)."""

    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    moe_every: int = 1
    impl: str = "dense"
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0

    def __eq__(self, other) -> bool:
        return _fields_equal(self, other)


@dataclass(frozen=True)
class ModelConfig:
    """One decoder: pre-norm layers of a mixer and an FFN. ``family``
    "dense": GQA with rope (or MLA) + an MLP in every layer; "ssm": an SSD
    mixer (``ssm``) and no FFN (mamba2); "moe": GQA + a mixture of experts
    (``moe``) on every ``moe.moe_every``-th layer, an MLP on the others;
    "hybrid": an attention layer where ``i % attn_every == attn_offset``, an
    SSD mixer on every other layer, and the FFNs as "moe" (jamba); "audio":
    as "dense", behind an encoder of ``encoder_layers`` non-causal layers
    over ``encoder_seq_len`` precomputed frame embeddings, with a
    cross-attention sublayer in every decoder layer (whisper); "vlm": as
    "dense", with ``n_patch_tokens`` precomputed patch embeddings, each put
    through ``patch_proj``, before the text (internvl2).
    ``mlp_kind``: "swiglu"
    (gate/up/down, silu), "gelu" (the gated GELU: gate/up/down) or "gelu2"
    (the classic up -> GELU -> down, no gate); ``norm_kind``: "rmsnorm" or
    "layernorm"."""

    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    lora_targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    citation: str = ""
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    # the LM head is the embedding's transpose (no ``lm_head`` leaf)
    tie_embeddings: bool = False
    # an encoder-decoder: the encoder's layers and its frames a row (0: a
    # decoder alone)
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    # a VLM: the patch-embedding positions before the text
    n_patch_tokens: int = 0
    max_seq_len: int = 131_072
    family: str = "dense"
    ssm: SSMConfig = field(default_factory=SSMConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    # a "hybrid" family's attention layers: every ``attn_every``-th, at
    # ``attn_offset`` in each period (jamba: 8 and 3, layers 3, 11, 19, 27)
    attn_every: int = 0
    attn_offset: int = 3

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per decoder layer: "ssm" in an SSM family; in a
        hybrid, "attn" where ``i % attn_every == attn_offset`` and "ssm"
        elsewhere; else "attn"."""
        return tuple(
            "ssm" if self.family == "ssm"
            else ("attn" if i % self.attn_every == self.attn_offset else "ssm")
            if self.family == "hybrid"
            else "attn"
            for i in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per decoder layer: "none" in an SSM family (mamba2
        blocks have no separate FFN); with ``moe`` enabled, "moe" on every
        ``moe_every``-th layer (layers moe_every - 1, 2 moe_every - 1, ...,
        as the reference) and a "dense" MLP between; else "dense"."""
        m = self.moe
        return tuple(
            "none" if self.family == "ssm"
            else "moe" if m.enabled and i % m.moe_every == m.moe_every - 1
            else "dense"
            for i in range(self.n_layers))

    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head rows padded to a multiple of 256, as in the
        reference; padded logits are masked to -1e30."""
        return (self.vocab_size + 255) // 256 * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LoraConfig:
    """One point of the LoRA hyperparameter space."""

    rank: int = 8
    alpha: float = 8.0
    learning_rate: float = 1e-4
    batch_size: int = 1
    seq_len: int = 1024

    def key(self) -> Tuple:
        """The fields that identify a configuration: ints and floats only, so
        ``hash(key())`` -- which seeds its data stream -- is the same in
        every process (``train/data.py``)."""
        return (self.rank, self.alpha, self.learning_rate, self.batch_size)


def attn_projections(acfg: AttentionConfig, d_model: int) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of one layer's attention projections, in the order the
    init draws them: q, k, v, o (GQA) or q_a, q_b, kv_a, kv_b_k, kv_b_v, o
    (MLA: q_b's heads are nope + rope wide, kv_a's output is the latent
    plus the shared rope part, o reads the v heads)."""
    h = acfg.n_heads
    if not acfg.is_mla:
        hd = acfg.head_dim
        return {"q": (d_model, h * hd), "k": (d_model, acfg.n_kv_heads * hd),
                "v": (d_model, acfg.n_kv_heads * hd), "o": (h * hd, d_model)}
    qlr, kvlr = acfg.q_lora_rank, acfg.kv_lora_rank
    dn, dr, dv = acfg.qk_nope_head_dim, acfg.qk_rope_head_dim, acfg.v_head_dim
    return {"q_a": (d_model, qlr), "q_b": (qlr, h * (dn + dr)), "kv_a": (d_model, kvlr + dr),
            "kv_b_k": (kvlr, h * dn), "kv_b_v": (kvlr, h * dv), "o": (h * dv, d_model)}


def ssm_projections(scfg: SSMConfig, d_model: int) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of one SSD layer's projections, in the order the init
    draws them: zx (z and x), bc (B and C), dt (a step per head), out."""
    di = scfg.d_inner(d_model)
    return {"zx": (d_model, 2 * di), "bc": (d_model, 2 * scfg.n_groups * scfg.d_state),
            "dt": (d_model, scfg.n_heads(d_model)), "out": (di, d_model)}


def mlp_projections(cfg: "ModelConfig") -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of a dense FFN's projections, in the order the init
    draws them (``MLP_PROJECTIONS[cfg.mlp_kind]``)."""
    d = cfg.d_model
    mlp = {"gate": (d, cfg.d_ff), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
    return {nm: mlp[nm] for nm in MLP_PROJECTIONS[cfg.mlp_kind]}


def layer_projections(cfg: "ModelConfig", mixer: str, ffn: str) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of every projection of one decoder layer of mixer
    ``mixer`` ("attn" or "ssm") and FFN ``ffn``: the mixer's, then a
    "dense" FFN's MLP (a "moe" or "none" FFN has none: the experts are
    batched weights, not projections, and carry no adapter)."""
    d = cfg.d_model
    mix = ssm_projections(cfg.ssm, d) if mixer == "ssm" else attn_projections(cfg.attention, d)
    return {**mix, **(mlp_projections(cfg) if ffn == "dense" else {})}


def lora_leaves(cfg: "ModelConfig", mixer: str, ffn: str) -> Dict[str, str]:
    """Each LoRA target of ``cfg.lora_targets`` that one layer of mixer
    ``mixer`` and FFN ``ffn`` has -> the projection it adapts: the mixer's
    targets (GQA's q/k/v/o; MLA's "q", "kv" and "o": ``q_a``, ``kv_a`` and
    ``o``; SSD's "ssm_in" and "ssm_out": ``zx`` and ``out``), then, on a
    "dense" FFN, the MLP's (a "gelu2" MLP has no gate). Each layer holds
    its own adapters, as the reference's ``init_layer`` builds them."""
    if mixer == "ssm":
        names = dict(SSM_TARGETS)
    else:
        names = dict(MLA_TARGETS) if cfg.attention.is_mla else {t: t for t in ("q", "k", "v", "o")}
    if ffn == "dense":
        names.update({nm: nm for nm in MLP_PROJECTIONS[cfg.mlp_kind]})
    return {t: names[t] for t in cfg.lora_targets if t in names}


def lora_layout(cfg: "ModelConfig", mixer: str, ffn: str,
                cross: bool = False) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """One layer's LoRA tree layout, as ``init_layer`` builds it: group
    ("attn" or "ssm" for the mixer, "cross" for an encoder-decoder's
    cross-attention, "mlp") -> adapted projection -> (d_in, d_out); a group
    without an adapter is left out. ``cross``: the layer is an
    encoder-decoder's decoder layer, whose "cross" group holds the GQA
    targets of ``lora_targets`` (whisper: q and v) at the GQA widths."""
    shapes = layer_projections(cfg, mixer, ffn)
    mlp = MLP_PROJECTIONS[cfg.mlp_kind] if ffn == "dense" else ()
    gqa = attn_projections(cfg.attention, cfg.d_model) if cross else {}
    groups: Dict[str, Dict[str, Tuple[int, int]]] = {
        "ssm" if mixer == "ssm" else "attn": {},
        "cross": {t: gqa[t] for t in cfg.lora_targets if t in gqa}, "mlp": {}}
    for leaf in lora_leaves(cfg, mixer, ffn).values():
        groups["mlp" if leaf in mlp else ("ssm" if mixer == "ssm" else "attn")][leaf] = shapes[leaf]
    # init_layer's order: the mixer, the cross-attention, the MLP
    return {grp: projs for grp, projs in groups.items() if projs}


def stack_layers(cfg: "ModelConfig") -> Dict[str, List[Tuple[str, str, bool]]]:
    """(mixer, ffn, cross) of every layer, by stack: "decoder" (each with
    the cross-attention group in an encoder-decoder) and, in an
    encoder-decoder, "encoder" (``ENCODER_LAYER``, no cross group): what
    ``lora_layout`` reads for each layer."""
    out = {"decoder": [(m, f, cfg.is_encdec) for m, f in zip(cfg.layer_kinds(),
                                                             cfg.ffn_kinds())]}
    if cfg.is_encdec:
        out["encoder"] = [(*ENCODER_LAYER, False)] * cfg.encoder_layers
    return out


def default_search_space(n: int = 120, seq_len: int = 1024) -> list:
    """Grid over the paper's Table 1 ranges: LR 2e-5..4e-4, BS 1..8, r
    8..128, alpha r/4..4r. The first ``n`` points of a deterministic grid,
    in the reference's order (``repro/configs/base.py:215-236``)."""
    space = [
        LoraConfig(rank=r, alpha=am * r, learning_rate=lr, batch_size=bs, seq_len=seq_len)
        for r in (8, 16, 32, 64, 128)
        for lr in (2e-5, 6e-5, 1e-4, 2e-4, 4e-4)
        for bs in (1, 2, 4, 8)
        for am in (0.25, 1.0, 4.0)
    ]
    return space[:n]


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Test-size variant of the same architecture, with the reference's
    rules (``repro/configs/base.py:243-297``): 2 layers (a model with
    ``global_every`` keeps one whole local:global period, at most 6
    layers), d_model <= 256, d_ff <= 384, head_dim 32, 2-4 heads, vocab
    512, a window of at most 64; MLA ranks 48 (q) and 32 (kv), q/k heads of
    16 nope + 16 rope, v heads of 32; SSD d_state 16, heads of 32, chunks of
    32 (every config carries an enabled ``ssm``, so every one shrinks, as
    in the reference); 4 experts of d_expert 64, top-k min(2, top_k), a
    capacity factor of 4 / top-k (nothing dropped); a hybrid keeps 4
    layers with ``attn_every=4``, ``attn_offset=1`` (SSD + dense, attention
    + MoE, SSD + dense, SSD + MoE); an encoder-decoder keeps 2 encoder
    layers over 32 frames, a VLM 8 patches; ``max_seq_len`` 512."""
    attn = cfg.attention
    n_heads = max(2, min(4, attn.n_heads))
    n_kv = max(1, min(n_heads, attn.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    mla = attn.is_mla
    new_attn = dataclasses.replace(
        attn, n_heads=n_heads, n_kv_heads=n_kv, head_dim=32,
        sliding_window=min(attn.sliding_window, 64) if attn.sliding_window else 0,
        q_lora_rank=48 if attn.q_lora_rank else 0, kv_lora_rank=32 if attn.kv_lora_rank else 0,
        qk_nope_head_dim=16 if mla else 0, qk_rope_head_dim=16 if mla else 0,
        v_head_dim=32 if mla else 0)
    ssm = cfg.ssm
    if ssm.enabled:
        ssm = dataclasses.replace(ssm, d_state=16, head_dim=32, chunk_size=32)
    moe = cfg.moe
    if moe.enabled:
        # capacity_factor = E / top_k: capacity >= T, no token dropped
        k = min(2, moe.top_k)
        moe = dataclasses.replace(moe, n_experts=4, top_k=k, d_expert=64, capacity_factor=4 / k)
    if cfg.family == "hybrid":
        n_layers = 4
        cfg = cfg.replace(attn_every=4, attn_offset=1)
    if attn.global_every:
        n_layers = min(max(n_layers, attn.global_every), 6)
    return cfg.replace(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=min(d_model, cfg.d_model),
        d_ff=min(384, cfg.d_ff),
        vocab_size=512,
        attention=new_attn,
        ssm=ssm,
        moe=moe,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq_len=32 if cfg.encoder_seq_len else 0,
        n_patch_tokens=8 if cfg.n_patch_tokens else 0,
        max_seq_len=512,
    )


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(cfg_fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    """Decorator: register ``<module>.config()`` under its arch id."""
    _REGISTRY[cfg_fn().name] = cfg_fn
    return cfg_fn


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401  (registers)
        command_r_35b,
        gemma3_1b,
        jamba_v01_52b,
        mamba2_370m,
        grok_1_314b,
        internvl2_1b,
        minicpm3_4b,
        qwen3_moe_30b_a3b,
        qwen25_7b,
        starcoder2_7b,
        whisper_tiny,
    )
