"""whisper-tiny -- encoder-decoder ASR backbone [arXiv:2212.04356].

4 encoder + 4 decoder layers, d_model=384, 6 heads (kv=6, head_dim=64),
biased q/k/v, LayerNorm, the gated GELU MLP of d_ff=1536, vocab=51865
(51,968 padded). The mel-spectrogram and conv front end is a stub: a batch
carries precomputed frame embeddings (B, 1500, 384), which the encoder
attends both ways; every decoder layer adds a cross-attention sublayer over
the encoder's output. Positions are rope, as the reference models it
(whisper's own are sinusoidal / learned). LoRA on q, v, gate, up and down,
in the encoder's layers and the decoder's, and on the decoder's cross q
and v.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        d_ff=1536,
        vocab_size=51_865,
        attention=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64, use_bias=True),
        mlp_kind="gelu",
        norm_kind="layernorm",
        encoder_layers=4,
        encoder_seq_len=1500,
        lora_targets=("q", "v", "gate", "up", "down"),
        max_seq_len=448,
        citation="arXiv:2212.04356 (Whisper)",
    )
