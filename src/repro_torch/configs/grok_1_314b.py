"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].

64L d_model=6144, 48 heads (GQA kv=8, head_dim=128), expert d_ff=32768,
vocab=131072, MoE 8e top-2 on every layer, on the dense-MoE path (every
expert on every token, gate-weighted), as the reference runs it. One card
holds it at no precision: the port runs it at ``reduced()`` size.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        d_ff=32_768,
        vocab_size=131_072,
        attention=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32_768, moe_every=1, impl="dense"),
        lora_targets=("q", "k", "v", "o"),
        citation="hf:xai-org/grok-1",
    )
