"""Explicit collectives over named mesh axes, for code under ``local_map``
(the reference's ``lax.psum``, ``lax.all_gather`` and ``lax.axis_index``
inside ``shard_map``).  They go through ``torch.distributed``'s functional
collectives, so a counting dispatch mode sees their payloads."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from .sharding import axis_names

__all__ = ["all_gather", "all_reduce", "linear_index"]


def linear_index(mesh, axes) -> int:
    """This rank's index over ``axes``, major axis first (``axis_index``
    over a tuple of axes)."""
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _groups(mesh, axes) -> list:
    """Process groups that, one after another, span ``axes``: the world's
    group when they are the whole mesh and the mesh the whole world, else
    one group per axis."""
    names = axis_names(mesh)
    if set(axes) == set(names) and mesh.size() == dist.get_world_size():
        return [dist.group.WORLD]
    return [(mesh, names.index(a)) for a in axes]


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _SumPassGrad(torch.autograd.Function):
    """Sum over the groups; the gradient passes through unchanged (each
    rank holds the full gradient of a replicated result)."""

    @staticmethod
    def forward(ctx, t, groups):
        t = t.contiguous()  # NCCL takes contiguous buffers only
        for g in groups:
            t = _wait(funcol.all_reduce(t, "sum", g))
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", or "max", which takes no gradient) of ``t`` over the
    ranks of ``axes``."""
    if op == "sum":
        return _SumPassGrad.apply(t, _groups(mesh, axes))
    t = t.contiguous()
    for g in _groups(mesh, axes):
        t = _wait(funcol.all_reduce(t, op, g))
    return t


def all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` of every rank of ``axes`` concatenated along dim 0, major axis
    first (``all_gather(..., tiled=True)``)."""
    t = t.contiguous()  # NCCL takes contiguous buffers only
    for g in reversed(_groups(mesh, axes)):  # innermost axis first
        t = _wait(funcol.all_gather_tensor_autograd(t, 0, g))
    return t
