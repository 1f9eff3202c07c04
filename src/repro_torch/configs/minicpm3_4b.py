"""minicpm3-4b — dense with Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B].

62L d_model=2560, 40 heads, d_ff=6400, vocab=73448. MLA: q_lora_rank=768,
kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64. As the reference
models it: MiniCPM's scale_emb, scale_depth, dim_model_base and rope
scaling are not modelled.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        n_layers=62,
        d_model=2560,
        d_ff=6400,
        vocab_size=73_448,
        attention=AttentionConfig(
            n_heads=40,
            n_kv_heads=40,
            head_dim=96,  # qk head dim = nope(64) + rope(32)
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        lora_targets=("q", "kv", "o", "gate", "up", "down"),
        citation="hf:openbmb/MiniCPM3-4B (MLA)",
    )
