from .base import (
    ARCH_IDS,
    SHAPES,
    Shape,
    cells,
    get_config,
    get_smoke,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "cells",
    "get_config",
    "get_smoke",
    "shape_applicable",
]
