"""RG-LRU recurrent block (RecurrentGemma / Griffin), as in
``repro/models/rglru.py``.

Temporal mixing: two branches from the (normed) input,
  gate branch:  linear -> GELU
  x branch:     linear -> causal conv1d(K=4) -> RG-LRU
merged multiplicatively, then projected back to d_model.

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_a x_t + b_a)            recurrence gate
  i_t = sigmoid(W_x x_t + b_x)            input gate
  log a_t = -c * softplus(Lambda) * r_t   (so a_t in (0, 1))
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill runs the reference's ``lax.associative_scan`` as a log-depth
doubling scan (Hillis-Steele) in f32 with the same combine; decode is the
O(1) step.  The gates run in f32 (``w_a`` and ``w_i`` widened on every call,
as the reference does); the scan's output is rounded to the activation
dtype before the gate product, and the state a prefill hands to decode is
that rounded value widened back to f32, as in the reference.  ``lam`` is
stored in f32.  The reference reaches no Pallas kernel here; these are
plain PyTorch ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import over_batch_and_heads

from .config import ModelConfig, RGLRUConfig
from .layers import _act, dense, param
from .ssm import _conv1d

__all__ = [
    "rglru_params",
    "rglru_apply",
    "rglru_decode",
    "rglru_init_cache",
    "rglru_naive",
]

_gelu = _act("gelu")  # jax.nn.gelu's default: the tanh approximation


def rglru_params(generator, cfg: ModelConfig, *, layers: int = 0, dtype, device) -> dict:
    r: RGLRUConfig = cfg.rglru
    d, w = cfg.d_model, r.lru_width
    kw = dict(layers=layers, dtype=dtype, device=device)
    return {
        "in_x": param(generator, (d, w), **kw),
        "in_gate": param(generator, (d, w), **kw),
        "conv_w": param(generator, (r.d_conv, w), scale=0.5, **kw),
        "conv_b": param(generator, (w,), init="zeros", **kw),
        "w_a": param(generator, (w, w), **kw),
        "b_a": param(generator, (w,), init="zeros", **kw),
        "w_i": param(generator, (w, w), **kw),
        "b_i": param(generator, (w,), init="zeros", **kw),
        "lam": torch.ones((layers, w) if layers else (w,), dtype=torch.float32, device=device),
        "out": param(generator, (w, d), **kw),
    }


def _gates(p: dict, x: torch.Tensor, c_exp: float):
    """a and the gated input b, both f32 [B, S, W]."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"].float())
    log_a = -c_exp * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * xf)
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after the step of stride k each position holds the composition of the
    2k positions ending at it, with the reference's combine
    ``(a1 a2, a2 b1 + b2)`` (earlier operand first)."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def rglru_apply(p: dict, xin: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence RG-LRU block.  xin [B, S, d] (already normed)."""
    r: RGLRUConfig = cfg.rglru
    gate = _gelu(dense(xin, p["in_gate"]))
    xproj = dense(xin, p["in_x"])
    a, b = _gates(p, _conv1d(xproj, p["conv_w"], p["conv_b"]), r.c_exponent)
    # channels are independent: on DTensors each rank scans its batch rows
    # and channels (``local_map``), where DTensor would split the sequence
    h = over_batch_and_heads(_scan, a, b).to(xin.dtype)
    y = dense(h * gate, p["out"])
    if return_cache:
        return y, (h[:, -1].float(), xproj[:, -(r.d_conv - 1) :, :])
    return y


def rglru_naive(p: dict, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Step-by-step oracle for tests."""
    cache = rglru_init_cache(cfg, xin.shape[0], dtype=xin.dtype, device=xin.device)
    outs = [rglru_decode(p, xin[:, t : t + 1], cfg, cache)[0] for t in range(xin.shape[1])]
    return torch.cat(outs, dim=1)


def rglru_init_cache(cfg: ModelConfig, bsz: int, dtype=torch.bfloat16, *, layers: int = 0,
                     device):
    """Zero cache ``(h f32 [B, W], conv tail [B, d_conv - 1, W])``, stacked
    ``[layers, ...]`` when ``layers`` > 0."""
    r: RGLRUConfig = cfg.rglru
    lead = (layers,) if layers else ()
    return (
        torch.zeros((*lead, bsz, r.lru_width), dtype=torch.float32, device=device),
        torch.zeros((*lead, bsz, r.d_conv - 1, r.lru_width), dtype=dtype, device=device),
    )


def rglru_decode(p: dict, xin: torch.Tensor, cfg: ModelConfig, cache):
    """One-token step.  xin [B, 1, d]; cache = (h, conv_tail), both updated
    in place (the reference returns new ones) and returned."""
    r: RGLRUConfig = cfg.rglru
    hprev, conv_tail = cache
    gate = _gelu(dense(xin, p["in_gate"]))  # [B, 1, W]
    window = torch.cat([conv_tail, dense(xin, p["in_x"])], dim=1)  # [B, K, W]
    x = (window * p["conv_w"]).sum(1, keepdim=True) + p["conv_b"]
    a, b = _gates(p, x, r.c_exponent)
    h = a[:, 0] * hprev + b[:, 0]
    y = dense(h[:, None, :].to(xin.dtype) * gate, p["out"])
    hprev.copy_(h)
    conv_tail.copy_(window[:, 1:])
    return y, (hprev, conv_tail)
