"""Residual block assembly, as in ``repro/models/blocks.py``.

Block kinds
-----------
  attn        GQA self-attention (+ gated MLP)        dense transformers
  local       sliding-window GQA (+ gated MLP)        recurrentgemma
  attn_dense  attention (GQA or MLA) + dense MLP      MoE models, first-k layers
  attn_moe    attention (GQA or MLA) + MoE            MoE models
  ssm         Mamba-2 SSD mixer (no MLP)              mamba2
  ssm_moe     Mamba-2 SSD mixer + MoE                 granite-4.0-h
  rglru       RG-LRU recurrence + gated MLP           recurrentgemma
  enc         bidirectional GQA + MLP                 seamless encoder
  xdec        causal self-attn + cross-attn + MLP     seamless decoder

Every apply returns ``(x, aux_loss, cache)`` so the layer loops in ``lm.py``
stay uniform; decode returns ``(x, cache)`` and updates ``cache`` in place.
A ``local`` block's cache is a ring of ``cfg.window`` slots: prefill
re-indexes its last ``window`` positions into the slots decode writes.  An
``xdec`` block's cache is the pair ``(self-attention K/V, memory K/V)``: the
encoder memory's K/V, which prefill computes and decode only reads.

Each block output is scaled by ``cfg.residual_scale`` before its residual
add where that is not 1 (Granite-4.0-H's 0.22); attention takes no rotary
embedding under ``cfg.nope``.
"""

from __future__ import annotations

import torch

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from repro_torch.parallel.sharding import constrain, merge_heads, split_heads

from .config import ModelConfig
from .layers import _act, dense, mrope, param, rms_norm, rope

__all__ = [
    "block_params",
    "block_apply",
    "block_decode",
    "block_init_cache",
    "make_rope_fn",
    "memory_kv",
]

_PORTED = ("attn", "local", "attn_dense", "attn_moe", "ssm", "ssm_moe", "rglru", "enc", "xdec")
_MOE = ("attn_moe", "ssm_moe")
_SSM = ("ssm", "ssm_moe")


# ------------------------------------------------------------------ MLP bits
def _mlp_params(generator, cfg: ModelConfig, d_ff: int | None = None, **kw) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act == "plain":  # non-gated (seamless)
        return {"w_in": param(generator, (d, f), **kw), "w_out": param(generator, (f, d), **kw)}
    return {
        "w_gate": param(generator, (d, f), **kw),
        "w_up": param(generator, (d, f), **kw),
        "w_down": param(generator, (f, d), **kw),
    }


def _mlp_apply(p: dict, x, cfg: ModelConfig):
    if "w_in" in p:
        return dense(torch.relu(dense(x, p["w_in"])), p["w_out"])
    act = _act(cfg.act if cfg.act in ("silu", "gelu") else "silu")
    return dense(act(dense(x, p["w_gate"])) * dense(x, p["w_up"]), p["w_down"])


def make_rope_fn(cfg: ModelConfig, positions):
    """positions: [B,S] (standard) or [3,B,S] (M-RoPE); none under NoPE."""
    if cfg.nope:
        return lambda x: x
    if cfg.mrope:
        return lambda x: mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return lambda x: rope(x, positions, cfg.rope_theta)


def _check(kind: str) -> None:
    if kind not in _PORTED:
        raise ValueError(f"unknown block kind {kind!r}")


def _attn_params(generator, cfg: ModelConfig, **kw):
    if cfg.mla is not None:
        return attn_mod.mla_params(generator, cfg, **kw)
    return attn_mod.gqa_params(generator, cfg, **kw)


# -------------------------------------------------------------------- params
def block_params(generator, cfg: ModelConfig, kind: str, *, layers: int = 0,
                 dtype, device) -> dict:
    """One block's parameters, each leaf stacked ``[layers, ...]`` when
    ``layers`` > 0 (the reference's scan-over-layers layout)."""
    _check(kind)
    kw = dict(layers=layers, dtype=dtype, device=device)
    p = {"norm1": param(generator, (cfg.d_model,), init="zeros", **kw)}
    if kind in _SSM:
        p["ssm"] = ssm_mod.ssm_params(generator, cfg, **kw)
        if kind == "ssm":  # the mixer alone: no MLP, no norm2
            return p
    elif kind == "rglru":
        p["rec"] = rglru_mod.rglru_params(generator, cfg, **kw)
    elif kind in ("enc", "xdec"):  # GQA whatever cfg.mla says, as the reference's
        p["attn"] = attn_mod.gqa_params(generator, cfg, **kw)
    else:
        p["attn"] = _attn_params(generator, cfg, **kw)
    if kind == "xdec":
        p["normx"] = param(generator, (cfg.d_model,), init="zeros", **kw)
        p["xattn"] = attn_mod.gqa_params(generator, cfg, **kw)
    p["norm2"] = param(generator, (cfg.d_model,), init="zeros", **kw)
    if kind in _MOE:
        p["moe"] = moe_mod.moe_params(generator, cfg, **kw)
    else:
        dense_ff = kind == "attn_dense" and cfg.moe and cfg.moe.d_ff_dense
        p["mlp"] = _mlp_params(generator, cfg, cfg.moe.d_ff_dense if dense_ff else None, **kw)
    return p


# --------------------------------------------------------------------- apply
def _self_attn(p, x, cfg: ModelConfig, aux, *, window: int, want_cache: bool,
               bidirectional: bool = False):
    """Returns (y, cache | None)."""
    if bidirectional:  # the encoder: rotary at its positions, no causal mask
        q, k, v = attn_mod._qkv(p, x, cfg, make_rope_fn(cfg, aux["positions"]))
        o = attn_mod.flash_attention(q, k, v, causal=False, chunk=aux["chunk"])
        y = dense(merge_heads(o), p["wo"])
        return y, ((k, v) if want_cache else None)
    if cfg.mla is not None:
        out = attn_mod.mla_attend(p, x, cfg, aux["positions"], chunk=aux["chunk"],
                                  return_cache=want_cache)
    else:
        out = attn_mod.gqa_attend(p, x, cfg, make_rope_fn(cfg, aux["positions"]),
                                  window=window, chunk=aux["chunk"], return_cache=want_cache)
    return out if want_cache else (out, None)


def _cross_attn(p, x, cfg: ModelConfig, mkv):
    """Cross-attention: q from ``x``, K/V the encoder memory's (no rotary on
    either), in key chunks of 1024 whatever the caller's chunk, as the
    reference's."""
    b, s, _ = x.shape
    q = split_heads(dense(x, p["wq"], p.get("bq")), cfg.n_heads, cfg.head_dim_)
    k, v = mkv
    o = attn_mod.flash_attention(q, k, v, causal=False, chunk=1024)
    return dense(merge_heads(o), p["wo"])


def memory_kv(p_xattn, memory, cfg: ModelConfig):
    """One decoder layer's K/V ``[B, S_enc, Hkv, hd]`` of the encoder memory."""
    b, s, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = split_heads(dense(memory, p_xattn["wk"], p_xattn.get("bk")), hkv, hd)
    v = split_heads(dense(memory, p_xattn["wv"], p_xattn.get("bv")), hkv, hd)
    return k, v


def block_apply(p, x, *, kind, cfg: ModelConfig, aux, want_cache=False):
    """Returns (x, aux_loss, cache); the aux loss is the MoE load-balance
    loss of an ``attn_moe`` block and 0 otherwise.  An ``xdec`` block
    cross-attends ``aux["memory_kv"]`` or, without it, the K/V of
    ``aux["memory"]`` (the encoder's output)."""
    _check(kind)
    x = constrain(x, aux.get("ctx"), ("dp", None, None))  # each block's input, as a layer's
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in _SSM:
        out = ssm_mod.ssm_apply(p["ssm"], xn, cfg, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
        if kind == "ssm":
            return x + y, 0.0, cache
    elif kind == "rglru":
        out = rglru_mod.rglru_apply(p["rec"], xn, cfg, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
    else:
        # As in the reference, "local" blocks, and "attn" blocks when
        # cfg.window is set, attend within cfg.window.
        y, cache = _self_attn(
            p["attn"], xn, cfg, aux,
            window=cfg.window if kind in ("attn", "local") else 0, want_cache=want_cache,
            bidirectional=kind == "enc",
        )
        if want_cache and kind == "local":
            cache = _ring_from_full(cache, cfg.window)
    x = _residual(x, _scaled(y, cfg), aux)
    if kind == "xdec":
        mkv = aux.get("memory_kv")
        if mkv is None:
            mkv = memory_kv(p["xattn"], aux["memory"], cfg)
        x = _residual(x, _cross_attn(p["xattn"], rms_norm(x, p["normx"], cfg.norm_eps), cfg, mkv),
                      aux)
        if want_cache:
            cache = (cache, mkv)
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind in _MOE:
        top_i, top_w, probs = moe_mod.route(p["moe"]["router"], xn, cfg.moe)
        aux_l = moe_mod.aux_load_balance_loss(probs, top_i, cfg.moe)
        y = moe_mod.moe_apply(p["moe"], xn, top_i, top_w, cfg, aux.get("ctx"))
        return x + _scaled(y, cfg), aux_l, cache
    return x + _scaled(_mlp_apply(p["mlp"], xn, cfg), cfg), 0.0, cache


def _scaled(y, cfg: ModelConfig):
    """A block output times ``cfg.residual_scale`` (left alone at 1)."""
    return y if cfg.residual_scale == 1.0 else y * cfg.residual_scale


def _residual(x, y, aux):
    """``x + y`` in the canonical activation layout: with a mesh the
    row-parallel product's partial sums are all-reduced here, before the
    next norm, as in Megatron's layout (left alone, DTensor carries them
    through the norm and gathers the next weights whole)."""
    return constrain(x + y, aux.get("ctx"), ("dp", None, None))


def _ring_from_full(kv, window: int):
    """Re-index the last ``window`` positions of prefill's K/V
    ``[B, S, Hkv, hd]`` into the ring's slots (position t in slot
    t mod window); slots no position reached stay zero."""
    k, v = kv
    p0 = k.shape[1]
    w = min(window, p0)
    idx = torch.arange(p0 - w, p0, device=k.device) % window
    ring = []
    for t in (k, v):
        r = t.new_zeros((t.shape[0], window, *t.shape[2:]))
        r[:, idx] = t[:, -w:]
        ring.append(r)
    return tuple(ring)


# -------------------------------------------------------------------- decode
def block_decode(p, x, *, kind, cfg: ModelConfig, aux, cache, pos):
    """Single-token step.  Returns (x, cache'); ``cache`` is updated in place
    (an ``xdec`` block's memory K/V only read)."""
    _check(kind)
    if kind == "xdec":
        cache, mkv = cache
        if mkv is None:
            raise ValueError("an xdec block decodes after a prefill: its memory K/V is None")
    x = constrain(x, aux.get("ctx"), ("dp", None, None))  # each block's input, as a layer's
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in _SSM:
        y, cache = ssm_mod.ssm_decode(p["ssm"], xn, cfg, cache)
        if kind == "ssm":
            return x + y, cache
    elif kind == "rglru":
        y, cache = rglru_mod.rglru_decode(p["rec"], xn, cfg, cache)
    elif cfg.mla is not None:
        y, cache = attn_mod.mla_decode(p["attn"], xn, cfg, cache, pos)
    else:
        # As in the reference, only "local" blocks decode against a window
        # (their ring): an "attn" block with cfg.window attends its whole
        # cache here.
        rope_fn = make_rope_fn(cfg, aux["positions"])
        y, cache = attn_mod.gqa_decode(p["attn"], xn, cfg, rope_fn, cache, pos,
                                       window=cfg.window if kind == "local" else 0)
    x = _residual(x, _scaled(y, cfg), aux)
    if kind == "xdec":
        x = _residual(x, _cross_attn(p["xattn"], rms_norm(x, p["normx"], cfg.norm_eps), cfg, mkv),
                      aux)
        cache = (cache, mkv)
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind in _MOE:
        top_i, top_w, _ = moe_mod.route(p["moe"]["router"], xn, cfg.moe)
        y = moe_mod.moe_apply(p["moe"], xn, top_i, top_w, cfg, aux.get("ctx"))
        return x + _scaled(y, cfg), cache
    return x + _scaled(_mlp_apply(p["mlp"], xn, cfg), cfg), cache


# --------------------------------------------------------------------- cache
def block_init_cache(cfg: ModelConfig, kind: str, bsz: int, cache_len: int, dtype,
                     *, layers: int, device):
    """Zero caches, stacked ``[layers, ...]``: K/V ``[B, cache_len, Hkv, hd]``
    (a ``local`` block's ring always ``cfg.window`` long, as the
    reference's), for MLA the compressed ``c`` ``[B, cache_len,
    kv_lora_rank]`` and the rope key ``[B, cache_len, qk_rope_dim]``; SSM
    and RG-LRU blocks their fixed-size states (:func:`ssm.ssm_init_cache`,
    :func:`rglru.rglru_init_cache`).  ``enc`` blocks keep no cache; an
    ``xdec`` block's pair is built by ``lm.init_caches``."""
    _check(kind)
    if kind in ("enc", "xdec"):
        raise ValueError(f"no cache for kind {kind!r}")
    if kind in _SSM:
        return ssm_mod.ssm_init_cache(cfg, bsz, dtype, layers=layers, device=device)
    if kind == "rglru":
        return rglru_mod.rglru_init_cache(cfg, bsz, dtype, layers=layers, device=device)
    if cfg.mla is not None:
        m = cfg.mla
        shapes = [(layers, bsz, cache_len, r) for r in (m.kv_lora_rank, m.qk_rope_dim)]
    else:
        slen = (cfg.window or cache_len) if kind == "local" else cache_len
        shapes = [(layers, bsz, slen, cfg.n_kv_heads, cfg.head_dim_)] * 2
    return tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes)
