"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1024, d_ff=0 (mamba2 blocks have no separate FFN), vocab=50280,
ssm_state=128, expand=2, head_dim=64 -> 32 SSD heads per block, tied
embeddings; LoRA on the in (z/x) and out projections.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        d_ff=0,
        vocab_size=50_280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        lora_targets=("ssm_in", "ssm_out"),
        citation="arXiv:2405.21060 (Mamba-2 / SSD)",
    )
