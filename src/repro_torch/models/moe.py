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

Expert parallelism, given a context with a mesh, is the reference's
``shard_map`` as ``local_map`` (:func:`moe_apply`): each rank dispatches its
own experts' pairs (the others sort last as strangers and are dropped
here), and explicit ``torch.distributed`` collectives combine the partial
outputs.  ``moe_dense_ref`` is the all-experts-dense oracle.  The reference
reaches no Pallas kernel here; these are plain PyTorch ops.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import over_batch, shard_map_compat, spec_of

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
    """Top-k routing.  Returns (top_idx [B,S,k], top_w [B,S,k], probs).
    On DTensors each rank routes its own batch rows (``over_batch``)."""
    return over_batch(lambda xl, wl: _route(wl, xl, m), (x,), (router_w,), n_out=3)


def _route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig):
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, m.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_i, top_w.to(x.dtype), probs


def aux_load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor, m: MoEConfig):
    """Switch-style load-balance auxiliary loss."""
    e = m.num_experts
    counts = _expert_counts(top_i, e).float()
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """How many of ``idx``'s picks go to each of the ``e`` experts (a
    ``bincount`` of fixed length, which a fake tensor can trace).  On a
    DTensor each rank counts its own piece (``shard_map_compat``) and the
    counts are summed over the mesh axes the piece is split on."""
    from torch.distributed.tensor import DTensor

    def count(t, mesh=None, split=()):
        t = t.reshape(-1).long()
        out = torch.zeros(e, dtype=torch.long, device=t.device).scatter_add_(
            0, t, torch.ones_like(t))
        return coll.all_reduce(out, mesh, split) if split else out

    if not isinstance(idx, DTensor):
        return count(idx)
    from repro_torch.parallel import collectives as coll

    mesh, spec = idx.device_mesh, spec_of(idx)
    split = tuple(a for entry in spec if entry is not None
                  for a in ((entry,) if isinstance(entry, str) else entry))
    return shard_map_compat(functools.partial(count, mesh=mesh, split=split), mesh=mesh,
                            in_specs=(spec,), out_specs=(None,))(idx)


def _expert_compute(xbuf, w1, w3, w2, act):
    h = torch.bmm(xbuf, w1)  # "ecd,edf->ecf"
    u = torch.bmm(xbuf, w3)
    h = act(h) * u
    return torch.bmm(h, w2)  # "ecf,efd->ecd"


def _dispatch_local(x2d, top_i, top_w, w1, w3, w2, *, m: MoEConfig, act,
                    rank: int = 0) -> torch.Tensor:
    """Select -> compute -> combine for this rank's experts.  [T, d] partial.

    Rank ``rank`` owns experts ``[rank * E_loc, (rank + 1) * E_loc)``; the
    other experts' pairs sort last as strangers and contribute zero.  On
    one device every expert is local (the reference's rank 0 of one).
    """
    t, d_model = x2d.shape
    e = w1.shape[0]  # E_loc
    k = m.top_k
    cap = int(math.ceil(t * m.top_k / m.num_experts * m.capacity_factor))
    dev = x2d.device

    local_e = top_i.reshape(-1) - rank * e  # [T*k]
    mine = (local_e >= 0) & (local_e < e)
    eid = torch.where(mine, local_e, e)  # strangers sort last
    n = eid.shape[0]
    order = torch.sort(eid, stable=True).indices
    key_sorted = eid[order]
    starts = torch.searchsorted(key_sorted, torch.arange(e + 1, device=dev, dtype=eid.dtype))
    slot_sorted = torch.arange(n, device=dev) - starts[key_sorted]
    ok = (key_sorted < e) & (slot_sorted < cap)
    tok_s = torch.div(order, k, rounding_mode="floor")  # the token of each sorted pair
    wgt_s = top_w.reshape(-1)[order]
    # gather tokens into the capacity buffer; dropped pairs land in one
    # spill row past the buffer, which is cut off
    dest = torch.where(ok, key_sorted * cap + slot_sorted, e * cap)
    buf = x2d.new_zeros((e * cap + 1, d_model))
    buf[dest] = x2d[tok_s]
    ybuf = _expert_compute(buf[: e * cap].view(e, cap, d_model), w1, w3, w2, act)
    vals = ybuf.reshape(e * cap, d_model)[
        key_sorted.clamp(max=e - 1) * cap + slot_sorted.clamp(0, cap - 1)]
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
    """Expert-parallel MoE forward (+ shared expert), given the routing.

    Two device layouts, selected by ``ctx.ep_axes``, as in the reference:

    * ``("model",)`` (training): experts sharded over TP, tokens replicated
      across 'model'; each rank selects its experts' tokens and one
      all-reduce over 'model' combines.  FSDP over 'data' happens outside:
      ``local_map`` gathers the weights' 'data' shards on the way in.
    * full mesh (serving, ``serve_context``): every rank owns E/P whole
      experts; the tokens are gathered across 'data' instead of the
      weights, and one all-reduce over the EP axes combines, after which
      each rank keeps its own tokens' rows.

    Without a mesh it is the one-device dispatch.  The all-reduces pass the
    gradient through unchanged and the replicated inputs' gradients come
    back partial, so training differentiates through the training layout.
    """
    m = cfg.moe
    mesh = getattr(ctx, "mesh", None)
    args = [x, top_i, top_w, params["w1"], params["w3"], params["w2"]]
    if m.num_shared:
        args += [params["ws1"], params["ws3"], params["ws2"]]
    if mesh is None:
        return _moe_body(*args, m=m, act=act, ctx=None)
    full_ep = len(ctx.ep_axes) > 1
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    ep = tuple(ctx.ep_axes) if full_ep else ctx.tp_axis
    tp = ctx.tp_axis
    specs = [(dp, None, None)] * 3 + [(ep, None, None)] * 3
    if m.num_shared:  # shared expert: TP
        specs += [(None, tp), (None, tp), (tp, None)]
    body = shard_map_compat(lambda *a: _moe_body(*a, m=m, act=act, ctx=ctx), mesh=mesh,
                            in_specs=specs, out_specs=(dp, None, None))
    return body(*args)


def _moe_body(x, top_i, top_w, w1, w3, w2, *shared, m: MoEConfig, act, ctx):
    """One rank's part of :func:`moe_apply` on local tensors (all of it
    without a mesh)."""
    from repro_torch.parallel import collectives as coll

    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    ti2, tw2 = top_i.reshape(-1, m.top_k), top_w.reshape(-1, m.top_k)
    full_ep = ctx is not None and len(ctx.ep_axes) > 1
    rank = 0
    if ctx is not None:
        rank = coll.linear_index(ctx.mesh, ctx.ep_axes if full_ep else (ctx.tp_axis,))
    if full_ep:
        t_loc = x2d.shape[0]
        x2d, ti2, tw2 = (coll.all_gather(a, ctx.mesh, ctx.dp_axes) for a in (x2d, ti2, tw2))
    out = _dispatch_local(x2d, ti2, tw2, w1, w3, w2, m=m, act=act, rank=rank)
    if shared:
        ws1, ws3, ws2 = shared
        sh = (act(x2d @ ws1) * (x2d @ ws3)) @ ws2
        if full_ep:
            # shared weights are sharded over 'model' only, so every 'data'
            # rank computes the same partial: pre-scale so the global
            # all-reduce does not multiply it by |data|
            sh = sh / ctx.size(ctx.dp_axes)
        out = out + sh
    if ctx is not None:
        out = coll.all_reduce(out, ctx.mesh, ctx.ep_axes if full_ep else (ctx.tp_axis,))
        if full_ep:
            start = coll.linear_index(ctx.mesh, ctx.dp_axes) * t_loc
            out = out[start:start + t_loc]
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
