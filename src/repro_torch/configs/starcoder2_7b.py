"""starcoder2-7b — dense GQA with RoPE [arXiv:2402.19173].

32L d_model=4608, 36 heads (GQA kv=4, head_dim=128), d_ff=18432, vocab=49152.
Classic (non-gated) GELU MLP with biases, LayerNorm.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        n_layers=32,
        d_model=4608,
        d_ff=18_432,
        vocab_size=49_152,
        attention=AttentionConfig(
            n_heads=36, n_kv_heads=4, head_dim=128, use_bias=True, rope_theta=1e5
        ),
        mlp_kind="gelu2",  # classic up->gelu->down MLP
        norm_kind="layernorm",
        citation="arXiv:2402.19173 (StarCoder2)",
    )
