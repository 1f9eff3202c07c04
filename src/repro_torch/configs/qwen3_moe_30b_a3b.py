"""qwen3-moe-30b-a3b — 128 experts top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048, 32 heads (GQA kv=4, head_dim=128), expert d_ff=768,
vocab=151936, MoE 128e top-8 on every layer. As the reference models it:
Qwen3's per-head q/k RMSNorm is not modelled.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        d_ff=768,
        vocab_size=151_936,
        attention=AttentionConfig(n_heads=32, n_kv_heads=4, head_dim=128, rope_theta=1e6),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, moe_every=1, impl="ep"),
        lora_targets=("q", "k", "v", "o"),
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
