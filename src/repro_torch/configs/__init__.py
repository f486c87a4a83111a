from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ModelConfig", "MoEConfig", "ShapeSpec",
    "SSMConfig", "get_config", "reduced_config",
]
