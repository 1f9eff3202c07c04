from repro_torch.configs.base import (
    AttentionConfig,
    LoraConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    default_search_space,
    get_config,
    list_archs,
    reduced,
)

__all__ = [
    "AttentionConfig",
    "LoraConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "default_search_space",
    "get_config",
    "list_archs",
    "reduced",
]
