"""Mesh construction, as in ``repro/launch/mesh.py``.

FUNCTIONS (not module-level constants), so importing this module never
touches a process group.  The production meshes keep the reference's shapes
and axis names: 16x16 = 256 ranks ('data' x 'model'), and two of them on a
leading 'pod' axis (512 ranks).  A mesh takes the first ranks of the
default process group, which must hold enough of them: on real cards one
rank a card (``torchrun`` with ``nccl``), on the CPU ``gloo``, and for the
dry-run a fake group of 256 or 512 ranks (``repro_torch.launch.dryrun``).
Every rank makes a mesh's groups together, in the same order: its dims',
and the flattened group of each set of two or more of them, which a
collective over several axes runs on (``parallel.collectives``).
"""

from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_debug_mesh", "make_workers_mesh", "mesh_device_type"]


def mesh_device_type() -> str:
    """The device type a mesh of the default group lives on: ``cuda`` under
    ``nccl``, else ``cpu`` (``gloo``, and the dry-run's fake group)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], hint: str):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, found {have} -- {hint}")
    from repro_torch.parallel.collectives import flatten_groups

    mesh = init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)
    flatten_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "run under launch/dryrun.py (it makes a fake group of "
                 "512 ranks) or on real hardware")


def make_debug_mesh(data: int, model: int, pod: int = 0):
    """Small mesh over the process group's first ranks (tests)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return _mesh(shape, axes, "start that many ranks (torchrun, or gloo processes)")


def make_workers_mesh(ranks: int, axis: str = "workers"):
    """A 1-D mesh over the first ``ranks`` ranks, for the device scheduler
    (``repro_torch.core.device_sched``), one block of workers a rank."""
    return _mesh((ranks,), (axis,), "start that many ranks (torchrun, or gloo processes)")
