from repro_torch.configs.base import (
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    shapes_for,
    reduce_config,
)
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_config, get_reduced, get_shape

__all__ = [
    "LayerSpec", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "shapes_for", "reduce_config",
    "ARCH_IDS", "all_cells", "get_config", "get_reduced", "get_shape",
]
