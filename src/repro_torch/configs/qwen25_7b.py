"""qwen25-7b — the paper's own primary base model [arXiv:2412.15115].

28L d_model=3584, 28 heads (GQA kv=4, head_dim=128), d_ff=18944, vocab=152064.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen25-7b",
        n_layers=28,
        d_model=3584,
        d_ff=18_944,
        vocab_size=152_064,
        attention=AttentionConfig(
            n_heads=28, n_kv_heads=4, head_dim=128, use_bias=True, rope_theta=1e6
        ),
        citation="arXiv:2412.15115 (Qwen2.5); paper §7 base model",
    )
