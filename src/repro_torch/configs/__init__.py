from repro_torch.configs.base import (
    AttentionConfig,
    LoraConfig,
    ModelConfig,
    get_config,
    list_archs,
    reduced,
)

__all__ = [
    "AttentionConfig",
    "LoraConfig",
    "ModelConfig",
    "get_config",
    "list_archs",
    "reduced",
]
