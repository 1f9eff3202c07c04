"""Model and LoRA configurations for the PyTorch port.

The port keeps its own copy of the reference's configuration dataclasses
(``repro.configs.base``), cut to what the dense GQA decoder needs: the port
imports nothing of the JAX package. Field names and defaults match the
reference, so a test can build the same configuration on both sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Grouped-query attention (the only attention kind of the port so far)."""

    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10_000.0
    use_bias: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """One dense decoder: pre-norm RMSNorm, GQA with rope, SwiGLU MLP,
    untied LM head (the reference's ``family="dense"`` defaults)."""

    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    lora_targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    citation: str = ""

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


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Test-size variant of the same architecture, with the reference's
    rules for a dense decoder: 2 layers, d_model <= 256, d_ff <= 384,
    head_dim 32, 2-4 heads, vocab 512."""
    attn = cfg.attention
    n_heads = max(2, min(4, attn.n_heads))
    n_kv = max(1, min(n_heads, attn.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    new_attn = dataclasses.replace(attn, n_heads=n_heads, n_kv_heads=n_kv, head_dim=32)
    return cfg.replace(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=min(d_model, cfg.d_model),
        d_ff=min(384, cfg.d_ff),
        vocab_size=512,
        attention=new_attn,
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
    from repro_torch.configs import qwen25_7b  # noqa: F401  (registers)
