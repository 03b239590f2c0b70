from repro_torch.configs.base import (
    ElasticConfig,
    ModelConfig,
    MorphMode,
    SHAPES,
    SHAPE_BY_NAME,
    ShapeCell,
    cell_applicable,
)
from repro_torch.configs.registry import ARCHS, get_config, list_archs, smoke_config

__all__ = [
    "ElasticConfig",
    "ModelConfig",
    "MorphMode",
    "SHAPES",
    "SHAPE_BY_NAME",
    "ShapeCell",
    "cell_applicable",
    "ARCHS",
    "get_config",
    "list_archs",
    "smoke_config",
]
