"""command-r-35b — dense GQA, no bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22528, vocab=256000,
tied embeddings. As in the reference, a sequential pre-norm RMSNorm SwiGLU
decoder: Cohere's parallel attention/MLP block, its LayerNorm and its logit
scale are not modelled. Its bf16 base (60.6 GB) does not fit one 80 GB card
beside a training step, so on one card it runs on an int8 or nf4 base built
layer by layer (``init_model(..., quant=)``).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        n_layers=40,
        d_model=8192,
        d_ff=22_528,
        vocab_size=256_000,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=8, head_dim=128, use_bias=False, rope_theta=8e6
        ),
        tie_embeddings=True,
        citation="hf:CohereForAI/c4ai-command-r-v01",
    )
