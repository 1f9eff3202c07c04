"""internvl2-1b -- VLM: InternViT + the Qwen2-0.5B LM [arXiv:2404.16821].

The LM: 24 layers, d_model=896, 14 heads (GQA kv=2, head_dim=64), biased
q/k/v, rope theta 1e6, d_ff=4864, vocab=151655. The vision encoder and
its projector are a stub: a batch carries 256 precomputed patch embeddings
(B, 256, 896), each put through a biased ``patch_proj`` (896 -> 896) and
placed before the text.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        d_ff=4864,
        vocab_size=151_655,
        attention=AttentionConfig(
            n_heads=14, n_kv_heads=2, head_dim=64, use_bias=True, rope_theta=1e6
        ),
        n_patch_tokens=256,
        citation="arXiv:2404.16821 (InternVL2); LM = Qwen2-0.5B",
    )
