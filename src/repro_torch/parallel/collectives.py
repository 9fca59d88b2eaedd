"""Explicit collectives over named mesh axes, for code under ``local_map``
or in a rank's own program (the reference's ``lax.psum``, ``lax.pmax``,
``lax.all_gather``, ``lax.ppermute``, ``lax.all_to_all`` and
``lax.axis_index`` inside ``shard_map``).  They go through
``torch.distributed``'s functional collectives, so a counting dispatch mode
sees their payloads.

Neither ``gloo`` nor NCCL takes a 16-bit integer tensor: ``ppermute`` and
``all_to_all`` send one as its bytes and give it back in its own dtype."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from .sharding import axis_names

__all__ = ["all_gather", "all_reduce", "all_to_all", "axis_rank", "axis_size", "linear_index",
           "ppermute"]

# dtypes no backend takes, sent as their bytes
_AS_BYTES = (torch.uint16, torch.int16)


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


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(axis_names(mesh).index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


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


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()  # NCCL takes contiguous buffers only
    return t.view(torch.uint8) if t.dtype in _AS_BYTES else t


def _from_wire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype in _AS_BYTES else t


def ppermute(t: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """``t`` of the rank ``shift`` places before this one along ``axis``
    (``lax.ppermute`` with the pairs ``(i, i + shift)``): each rank sends its
    ``t`` to rank ``(r + shift) mod n``.  ``t`` crosses flattened, as one
    all-to-all whose splits are all 0 but one, and comes back in its shape;
    with one rank it stays where it is."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    r = axis_rank(mesh, axis)
    wire = _to_wire(t).reshape(-1)
    sends, recvs = [0] * n, [0] * n
    sends[(r + shift) % n] = recvs[(r - shift) % n] = wire.numel()
    got = _wait(funcol.all_to_all_single(wire, recvs, sends, _groups(mesh, (axis,))[0]))
    return _from_wire(got, t.dtype).view(t.shape)


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(t, axis, 0, 0)`` over ``[n, ...]`` blocks: block
    ``s`` of ``t`` goes to rank ``s``, and block ``s`` of the result came
    from rank ``s``."""
    got = _wait(funcol.all_to_all_single(_to_wire(t), None, None,
                                         _groups(mesh, (axis,))[0]))
    return _from_wire(got, t.dtype)
