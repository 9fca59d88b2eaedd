"""Residual block assembly, as in ``repro/models/blocks.py``.

Block kinds ported so far
-------------------------
  attn        GQA self-attention (+ gated MLP)        dense transformers

Every other kind of the reference (``local``, ``attn_dense``, ``attn_moe``,
``ssm``, ``rglru``, ``enc``, ``xdec``) and MLA attention raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.

Every apply returns ``(x, aux_loss, cache)`` so the layer loops in ``lm.py``
stay uniform; decode returns ``(x, cache)``.
"""

from __future__ import annotations

import torch

from . import attention as attn_mod
from .config import ModelConfig
from .layers import _act, dense, mrope, param, rms_norm, rope

__all__ = [
    "block_params",
    "block_apply",
    "block_decode",
    "block_init_cache",
    "make_rope_fn",
    "not_ported",
]

# Where in ROADMAP.md (§1, the queue) each missing part is ported.
_ROADMAP_ITEM = {
    "mla": "queue item 2, MoE + MLA",
    "attn_dense": "queue item 2, MoE + MLA",
    "attn_moe": "queue item 2, MoE + MLA",
    "ssm": "queue item 3, SSM",
    "rglru": "queue item 4, RG-LRU with local attention",
    "local": "queue item 4, RG-LRU with local attention",
    "enc": "queue item 5, encoder-decoder",
    "xdec": "queue item 5, encoder-decoder",
    "frontend": "queue item 6, VLM",
    "mtp": "queue item 8, training",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a part of the reference the port does not have yet."""
    return NotImplementedError(
        f"{what!r} is not ported yet: ROADMAP.md §1, {_ROADMAP_ITEM[what]}"
    )


# ------------------------------------------------------------------ MLP bits
def _mlp_params(generator, cfg: ModelConfig, d_ff: int | None = None, **kw) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act == "plain":  # non-gated (seamless)
        raise not_ported("enc")
    return {
        "w_gate": param(generator, (d, f), **kw),
        "w_up": param(generator, (d, f), **kw),
        "w_down": param(generator, (f, d), **kw),
    }


def _mlp_apply(p: dict, x, cfg: ModelConfig):
    act = _act(cfg.act if cfg.act in ("silu", "gelu") else "silu")
    return dense(act(dense(x, p["w_gate"])) * dense(x, p["w_up"]), p["w_down"])


def make_rope_fn(cfg: ModelConfig, positions):
    """positions: [B,S] (standard) or [3,B,S] (M-RoPE)."""
    if cfg.mrope:
        return lambda x: mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return lambda x: rope(x, positions, cfg.rope_theta)


def _check(cfg: ModelConfig, kind: str) -> None:
    if kind in _ROADMAP_ITEM:
        raise not_ported(kind)
    if kind != "attn":
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.mla is not None:
        raise not_ported("mla")


# -------------------------------------------------------------------- params
def block_params(generator, cfg: ModelConfig, kind: str, *, layers: int = 0,
                 dtype, device) -> dict:
    """One block's parameters, each leaf stacked ``[layers, ...]`` when
    ``layers`` > 0 (the reference's scan-over-layers layout)."""
    _check(cfg, kind)
    kw = dict(layers=layers, dtype=dtype, device=device)
    return {
        "norm1": param(generator, (cfg.d_model,), init="zeros", **kw),
        "attn": attn_mod.gqa_params(generator, cfg, **kw),
        "norm2": param(generator, (cfg.d_model,), init="zeros", **kw),
        "mlp": _mlp_params(generator, cfg, **kw),
    }


# --------------------------------------------------------------------- apply
def block_apply(p, x, *, kind, cfg: ModelConfig, aux, want_cache=False):
    """Returns (x, aux_loss, cache)."""
    _check(cfg, kind)
    rope_fn = make_rope_fn(cfg, aux["positions"])
    out = attn_mod.gqa_attend(
        p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, rope_fn,
        window=cfg.window, chunk=aux["chunk"], return_cache=want_cache,
    )
    y, cache = out if want_cache else (out, None)
    x = x + y
    x = x + _mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x, 0.0, cache


# -------------------------------------------------------------------- decode
def block_decode(p, x, *, kind, cfg: ModelConfig, aux, cache, pos):
    """Single-token step.  Returns (x, cache'); ``cache`` is updated in place."""
    _check(cfg, kind)
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    rope_fn = make_rope_fn(cfg, aux["positions"])
    # As in the reference, only "local" blocks decode against a window: an
    # "attn" block with cfg.window attends its whole cache here.
    y, cache = attn_mod.gqa_decode(p["attn"], xn, cfg, rope_fn, cache, pos, window=0)
    x = x + y
    x = x + _mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x, cache


# --------------------------------------------------------------------- cache
def block_init_cache(cfg: ModelConfig, kind: str, bsz: int, cache_len: int, dtype,
                     *, layers: int, device):
    """Zero K/V caches ``[layers, B, cache_len, Hkv, hd]``."""
    _check(cfg, kind)
    shape = (layers, bsz, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
