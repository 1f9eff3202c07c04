"""jamba-v0.1-52b -- Mamba+attention 1:7 hybrid with MoE [arXiv:2403.19887].

32L d_model=4096; attention layers (GQA 32H kv=8, head_dim=128) every 8th
layer (layers 3, 11, 19, 27); MoE (16 experts top-2, d_ff=14336) every
other layer, a dense SwiGLU MLP of 14336 on the others; vocab=65536.
Jamba uses Mamba-1 blocks (d_state=16); as the reference models it, the
SSD (Mamba-2) formulation of the scan with d_state=16. Each layer carries
the adapters of its own mixer: q/k/v/o on the attention layers, zx/out
("ssm_in"/"ssm_out") on the SSD ones.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, SSMConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        d_ff=14_336,
        vocab_size=65_536,
        attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14_336, moe_every=2, impl="ep"),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
        attn_every=8,
        attn_offset=3,
        lora_targets=("q", "k", "v", "o", "ssm_in", "ssm_out"),
        citation="arXiv:2403.19887 (Jamba)",
    )
