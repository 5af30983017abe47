from .base import SHAPES, ArchConfig, ShapeConfig
from .registry import (ARCH_IDS, cells, get_config, get_smoke,
                       shape_supported)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "cells",
           "get_config", "get_smoke", "shape_supported"]
