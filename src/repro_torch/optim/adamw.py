"""AdamW with global-norm clipping and a cosine schedule, as in
``repro/optim/adamw.py``.

Functional over the port's parameter trees (plain nested dicts of
tensors), not ``torch.optim.AdamW``: as in the reference, weight decay
applies to every leaf with ``ndim >= 2``, which, with the layer groups
stacked ``[L, ...]``, takes in the stacked norm scales; it is added with the
old parameter in the same step expression; and the moments are kept in
``moment_dtype``.  Every quantity is a tensor on the parameters' device,
so a step waits for nothing on the host.

``adamw_update`` writes the new parameters and moments into the tensors it
was given (the counterpart of the reference's buffer donation under
``jit``): old trees beside new ones would hold 28.4 GB more for phi4-mini at
full width and 16 layers (bf16 parameters, f32 moments).  A caller that
needs the old values passes copies.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.autodiff import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr", "global_norm"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig):
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731 (a DTensor keeps its layout)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares, the leaves added in JAX's order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` divided, as the reference divides: a Python number over
    a tensor is a reciprocal times the number in torch."""
    return torch.div(torch.tensor(num, dtype=torch.float32, device=den.device), den)


def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One step, in place.  Returns (new_params, new_opt_state, metrics),
    metrics ``grad_norm`` and ``clip_scale`` as 0-dim f32 tensors.  The new
    values are written into ``params`` and ``opt_state``'s moments, which
    come back as the new trees."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(_div(cfg.clip_norm, torch.clamp(gnorm, min=1e-9)), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, count.float())
    c2 = 1.0 - torch.pow(b2, count.float())
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        return p.copy_(p.float() - lr * step), m.copy_(m32), v.copy_(v32)

    flat = zip(*(tree_leaves(t) for t in (grads, opt_state["m"], opt_state["v"], params)))
    out = [upd(g, m, v, p) for g, m, v, p in flat]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return (
        new_p,
        {"m": new_m, "v": new_v, "count": count},
        {"grad_norm": gnorm, "clip_scale": scale},
    )


def cosine_lr(step, *, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Warmup + cosine decay multiplier in [floor, 1], a 0-dim f32 tensor on
    ``step``'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (floor + (1.0 - floor) * cos)
