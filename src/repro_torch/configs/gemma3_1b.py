"""gemma3-1b — dense, 5:1 local:global sliding-window [hf:google/gemma-3-1b-pt].

26L d_model=1152, 4 heads (GQA kv=1, head_dim=256), d_ff=6912, vocab=262144.
Local layers use a 512-token sliding window with rope theta 10k; every 6th
layer is global with rope theta 1M. Gated GELU MLP, tied embeddings.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        n_layers=26,
        d_model=1152,
        d_ff=6912,
        vocab_size=262_144,
        attention=AttentionConfig(
            n_heads=4,
            n_kv_heads=1,
            head_dim=256,
            rope_theta=10_000.0,
            sliding_window=512,
            global_every=6,
            global_rope_theta=1e6,
        ),
        mlp_kind="gelu",  # gemma uses geglu; the gated-gelu variant
        tie_embeddings=True,
        citation="hf:google/gemma-3-1b-pt",
    )
