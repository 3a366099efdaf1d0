"""Architecture and shape configs (one module per assigned arch)."""
from .base import (
    ArchConfig, MLAConfig, MoEConfig, ShapeConfig, SHAPES,
    SUBQUADRATIC, runnable_cells)
from .registry import ARCH_IDS, all_archs, get_arch, get_reduced

__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig", "ShapeConfig", "SHAPES",
    "SUBQUADRATIC", "runnable_cells",
    "ARCH_IDS", "all_archs", "get_arch", "get_reduced",
]
