"""Configs of the port: ArchConfig/ShapeConfig dataclasses, the LM arch modules
with their registry, and the SNN configurations (data only)."""

from .base import PORT_FIELDS, SHAPES, ArchConfig, ShapeConfig, reduced
from .registry import (LONG_CONTEXT_OK, PORT_ONLY, cell_is_live, get_config,
                       get_reduced, list_archs, shape_cells)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "reduced", "cell_is_live",
           "get_config", "get_reduced", "list_archs", "shape_cells",
           "LONG_CONTEXT_OK", "PORT_FIELDS", "PORT_ONLY"]
