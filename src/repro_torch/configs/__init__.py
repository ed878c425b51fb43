from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_archs,
    all_cells,
    applicable,
    get_arch,
    get_shape,
    reduced_on,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "all_archs",
    "all_cells",
    "applicable",
    "get_arch",
    "get_shape",
    "reduced_on",
]
