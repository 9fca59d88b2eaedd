"""Architecture registry + input-shape sets for the assigned pool.

Every assigned architecture has one module in this package exposing

    CONFIG : ModelConfig   -- the exact published configuration
    SMOKE  : ModelConfig   -- reduced same-family config for CPU smoke tests

and this module provides the registry (``get_config``/``get_smoke``), the four
assigned LM input shapes and the applicability rules (long_500k needs
sub-quadratic mixing).  The reference's ``input_specs`` (stand-ins for the
multi-pod dry-run's inputs) comes with the port's dry-run machinery.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "get_config",
    "get_smoke",
    "shape_applicable",
    "cells",
]

ARCH_IDS = (
    "moonshot-v1-16b-a3b",
    "deepseek-v3-671b",
    "qwen2-vl-2b",
    "mistral-nemo-12b",
    "minitron-4b",
    "qwen1.5-32b",
    "phi4-mini-3.8b",
    "recurrentgemma-2b",
    "mamba2-2.7b",
    "seamless-m4t-medium",
)


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    subquadratic_only: bool = False


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1, subquadratic_only=True),
}


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(applicable, reason).  DESIGN.md §Arch-applicability."""
    if shape.subquadratic_only:
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, (
            "full attention at 524k context is quadratic by construction; "
            "run only for SSM/hybrid families"
        )
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch_id, shape) cells of the assignment (40 incl. skips)."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for sh in SHAPES.values():
            ok, reason = shape_applicable(cfg, sh)
            if ok or include_skipped:
                out.append((a, sh.name, ok, reason))
    return out
