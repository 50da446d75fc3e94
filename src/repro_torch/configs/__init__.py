"""Configs of the port: ArchConfig/ShapeConfig dataclasses, the ten LM arch
modules with their registry, and the SNN configurations (data only)."""

from .base import SHAPES, ArchConfig, ShapeConfig, reduced
from .registry import (LONG_CONTEXT_OK, cell_is_live, get_config,
                       get_reduced, list_archs, shape_cells)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "reduced", "cell_is_live",
           "get_config", "get_reduced", "list_archs", "shape_cells",
           "LONG_CONTEXT_OK"]
