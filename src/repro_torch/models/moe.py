"""Mixture-of-Experts layer on one device, as in ``repro/models/moe.py``.

* Routing: softmax over f32 router logits, top-k (ties to the lower expert
  id, as ``lax.top_k``), weights renormalised and cast to the activation
  dtype.  The router is stored in f32 whatever the model's dtype.
* Dispatch (``_dispatch_local``): the (token, pick) pairs are stably sorted
  by expert; each expert takes at most ``cap = ceil(t * top_k / E * cf)`` of
  them into a ``[E, cap, d]`` buffer, and the rest are dropped (GShard
  semantics).  The gated MLP runs as one batched product over every
  expert, as the reference's einsum does.
* Combine: each token's kept contributions are added one at a time in the
  activation dtype, sorted by expert, the order in which the reference's
  scatter-add applies them on the CPU.  No atomics, so a token's output is
  the same bits on every run.
* The shared expert (DeepSeek) is a dense gated MLP added to the result.

The reference's expert parallelism (``shard_map`` over the mesh) comes with
the port's parallel slice: given a context that carries a mesh,
``moe_apply`` raises.  ``moe_dense_ref`` is the all-experts-dense oracle.
The reference reaches no Pallas kernel here; these are plain PyTorch ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.roadmap import not_ported

from .config import ModelConfig, MoEConfig
from .layers import param

__all__ = [
    "moe_params",
    "route",
    "moe_apply",
    "moe_dense_ref",
    "aux_load_balance_loss",
]


def moe_params(generator, cfg: ModelConfig, *, layers: int = 0, dtype, device) -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    f = m.d_expert
    kw = dict(layers=layers, dtype=dtype, device=device)
    p = {
        "router": param(generator, (d, m.num_experts), layers=layers,
                        dtype=torch.float32, device=device),
        "w1": param(generator, (m.num_experts, d, f), **kw),
        "w3": param(generator, (m.num_experts, d, f), **kw),
        "w2": param(generator, (m.num_experts, f, d), **kw),
    }
    if m.num_shared:
        fs = (m.d_shared or f) * m.num_shared
        p["ws1"] = param(generator, (d, fs), **kw)
        p["ws3"] = param(generator, (d, fs), **kw)
        p["ws2"] = param(generator, (fs, d), **kw)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig):
    """Top-k routing.  Returns (top_idx [B,S,k], top_w [B,S,k], probs)."""
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, m.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_i, top_w.to(x.dtype), probs


def aux_load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor, m: MoEConfig):
    """Switch-style load-balance auxiliary loss."""
    e = m.num_experts
    counts = torch.bincount(top_i.reshape(-1), minlength=e).float()
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef


def _expert_compute(xbuf, w1, w3, w2, act):
    h = torch.bmm(xbuf, w1)  # "ecd,edf->ecf"
    u = torch.bmm(xbuf, w3)
    h = act(h) * u
    return torch.bmm(h, w2)  # "ecf,efd->ecd"


def _dispatch_local(x2d, top_i, top_w, w1, w3, w2, *, m: MoEConfig, act) -> torch.Tensor:
    """Select -> compute -> combine over every expert.  [T, d].

    On one device every expert is local (the reference's rank 0 of one), so
    no pair sorts last as a stranger's.
    """
    t, d_model = x2d.shape
    e = w1.shape[0]
    k = m.top_k
    cap = int(math.ceil(t * m.top_k / m.num_experts * m.capacity_factor))
    dev = x2d.device

    eid = top_i.reshape(-1)  # [T*k]
    n = eid.shape[0]
    order = torch.sort(eid, stable=True).indices
    key_sorted = eid[order]
    starts = torch.searchsorted(key_sorted, torch.arange(e + 1, device=dev, dtype=eid.dtype))
    slot_sorted = torch.arange(n, device=dev) - starts[key_sorted]
    ok = slot_sorted < cap
    tok_s = torch.div(order, k, rounding_mode="floor")  # the token of each sorted pair
    wgt_s = top_w.reshape(-1)[order]
    # gather tokens into the capacity buffer; dropped pairs land in one
    # spill row past the buffer, which is cut off
    dest = torch.where(ok, key_sorted * cap + slot_sorted, e * cap)
    buf = x2d.new_zeros((e * cap + 1, d_model))
    buf[dest] = x2d[tok_s]
    ybuf = _expert_compute(buf[: e * cap].view(e, cap, d_model), w1, w3, w2, act)
    vals = ybuf.reshape(e * cap, d_model)[key_sorted * cap + slot_sorted.clamp(max=cap - 1)]
    vals = vals * wgt_s[:, None]
    # combine: token i's pairs sit at sorted positions pos[i] (ascending =
    # by expert); add them one by one, dropped ones as exact zeros
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    pos = inv.view(t, k).sort(dim=1).values
    contrib = torch.where(ok[pos][..., None], vals[pos], 0.0)  # [T, k, d]
    out = torch.zeros((t, d_model), dtype=x2d.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_apply(
    params: dict,
    x: torch.Tensor,  # [B, S, d]
    top_i: torch.Tensor,
    top_w: torch.Tensor,
    cfg: ModelConfig,
    ctx=None,
    act=F.silu,
) -> torch.Tensor:
    """MoE forward (+ shared expert) on one device, given the routing."""
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        raise not_ported("sharded serving")
    m = cfg.moe
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    out = _dispatch_local(
        x2d, top_i.reshape(-1, m.top_k), top_w.reshape(-1, m.top_k),
        params["w1"], params["w3"], params["w2"], m=m, act=act,
    )
    if m.num_shared:
        h = act(x2d @ params["ws1"]) * (x2d @ params["ws3"])
        out = out + h @ params["ws2"]
    return out.reshape(x.shape)


def moe_dense_ref(params, x, cfg: ModelConfig, act=F.silu):
    """Oracle: every expert computes every token; combine with top-k weights."""
    m = cfg.moe
    top_i, top_w, _ = route(params["router"], x, m)
    h = torch.einsum("bsd,edf->bsef", x, params["w1"])
    u = torch.einsum("bsd,edf->bsef", x, params["w3"])
    y_all = torch.einsum("bsef,efd->bsed", act(h) * u, params["w2"])
    mask = F.one_hot(top_i, m.num_experts).to(x.dtype)  # [B,S,k,E]
    w_full = (mask * top_w[..., None]).sum(-2)  # [B,S,E]
    out = torch.einsum("bsed,bse->bsd", y_all, w_full)
    if m.num_shared:
        h = act(x @ params["ws1"]) * (x @ params["ws3"])
        out = out + h @ params["ws2"]
    return out
