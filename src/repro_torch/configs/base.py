"""Architecture registry + input-shape sets for the assigned pool.

Every assigned architecture has one module in this package exposing

    CONFIG : ModelConfig   -- the exact published configuration
    SMOKE  : ModelConfig   -- reduced same-family config for CPU smoke tests

and this module provides the registry (``get_config``/``get_smoke``), the four
assigned LM input shapes, the applicability rules (long_500k needs
sub-quadratic mixing), and ``input_specs`` -- ``meta`` stand-ins for every
model input of a (config, shape) cell, what the dry-run traces against.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "get_config",
    "get_smoke",
    "shape_applicable",
    "input_specs",
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


# --------------------------------------------------------------------- specs
def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """``meta`` stand-ins for the batch of one (arch, shape) cell, in the
    reference's shapes and dtypes.

    train:    full-sequence batch for ``train_step``.
    prefill:  prompt batch for ``prefill_step``.
    decode:   one new token against a ``shape.seq_len``-token KV cache
              (the cache itself is built by the serve engine, not here).
    """
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def emb():
        return torch.empty((b, s, cfg.d_model), dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            # patch/frame embeddings from the stubbed frontend + M-RoPE ids
            batch = {"embeds": emb(), "positions": _i32(3, b, s)}
        elif cfg.enc_layers:
            batch = {"enc_embeds": emb(), "tokens": _i32(b, s)}
        else:
            batch = {"tokens": _i32(b, s)}
        if shape.kind == "train":
            batch["labels"] = _i32(b, s)
        return batch
    if shape.kind == "decode":
        return {"tokens": _i32(b, 1), "pos": _i32()}
    raise ValueError(shape.kind)


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
