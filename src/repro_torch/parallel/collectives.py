"""Explicit collectives over named mesh axes, for code under ``local_map``
or in a rank's own program (the reference's ``lax.psum``, ``lax.pmax``,
``lax.all_gather``, ``lax.ppermute``, ``lax.all_to_all`` and
``lax.axis_index`` inside ``shard_map``).  They go through
``torch.distributed``'s functional collectives, so a counting dispatch mode
sees their payloads.  A collective over several mesh axes is one collective
over their flattened group (``lax.psum`` over a tuple of axes is one too):
:func:`flatten_groups` makes those groups when the mesh is made.

Neither ``gloo`` nor NCCL takes a 16-bit integer tensor: ``ppermute`` and
``all_to_all`` send one as its bytes and give it back in its own dtype."""

from __future__ import annotations

import itertools

import torch
import torch.distributed._functional_collectives as funcol

from .sharding import axis_names

__all__ = ["all_gather", "all_reduce", "all_to_all", "axis_rank", "axis_size",
           "flatten_groups", "linear_index", "ppermute", "sum_shares"]

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


# (mesh, axes in the mesh's order) -> the flattened mesh spanning them
_FLAT: dict = {}


def flatten_groups(mesh) -> None:
    """Make the flattened group of every set of two or more of ``mesh``'s
    axes, in the mesh's order (``DeviceMesh._flatten``; DTensor's own
    redistributes then take them too).  Making a group is a collective over
    the whole world, so every rank calls this once, when the mesh is made
    (``launch/mesh.py`` does), in the same order."""
    names = axis_names(mesh)
    for k in range(2, len(names) + 1):
        for axes in itertools.combinations(names, k):
            _FLAT[(mesh, axes)] = mesh[axes]._flatten()


def _group(mesh, axes):
    """The one process group that spans ``axes`` (names in the mesh's
    major-to-minor order), its ranks ordered major axis first: the mesh
    dim of one axis, or the flattened group of several."""
    names = axis_names(mesh)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx) or len(set(idx)) != len(idx):
        raise ValueError(f"axes {tuple(axes)} are not in the mesh's order {names}")
    if len(axes) == 1:
        return (mesh, idx[0])
    flat = _FLAT.get((mesh, tuple(axes)))
    if flat is None:
        raise ValueError(f"no flattened group of {tuple(axes)}: make the mesh with "
                         "repro_torch.launch.mesh (or call flatten_groups on every rank)")
    return (flat, 0)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _Sum(torch.autograd.Function):
    """Sum over the group.  The gradient passes through unchanged where each
    rank holds the full gradient of a replicated result, and with
    ``shares`` is summed over the group too: each rank then holds only its
    own part's gradient of the sum, and each share's gradient is all of
    theirs."""

    @staticmethod
    def forward(ctx, t, group, shares):
        ctx.group, ctx.shares = group, shares
        return _wait(funcol.all_reduce(t.contiguous(), "sum", group))  # NCCL: contiguous only

    @staticmethod
    def backward(ctx, grad):
        if ctx.shares:
            grad = _wait(funcol.all_reduce(grad.contiguous(), "sum", ctx.group))
        return grad, None, None


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", or "max", which takes no gradient) of ``t`` over the
    ranks of ``axes``, as one collective.  The sum's gradient passes
    through: its result is used whole, the same on every rank."""
    group = _group(mesh, axes)
    if op == "sum":
        return _Sum.apply(t, group, False)
    return _wait(funcol.all_reduce(t.contiguous(), op, group))


def sum_shares(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes``, for a sum whose
    result each rank then uses only with its own part of a split tensor
    (a norm's sum of squares over a split feature dim): its gradient is
    the sum over the ranks of theirs (``lax.psum`` of a varying value)."""
    return _Sum.apply(t, _group(mesh, axes), True)


def all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` of every rank of ``axes`` concatenated along dim 0, major axis
    first (``all_gather(..., tiled=True)``), as one collective; the
    gradient is reduce-scattered back."""
    t = t.contiguous()  # NCCL takes contiguous buffers only
    return _wait(funcol.all_gather_tensor_autograd(t, 0, _group(mesh, axes)))


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
    got = _wait(funcol.all_to_all_single(wire, recvs, sends, _group(mesh, (axis,))))
    return _from_wire(got, t.dtype).view(t.shape)


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(t, axis, 0, 0)`` over ``[n, ...]`` blocks: block
    ``s`` of ``t`` goes to rank ``s``, and block ``s`` of the result came
    from rank ``s``."""
    got = _wait(funcol.all_to_all_single(_to_wire(t), None, None,
                                         _group(mesh, (axis,))))
    return _from_wire(got, t.dtype)
