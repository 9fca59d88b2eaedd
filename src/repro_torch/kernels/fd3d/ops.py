"""Public op for the fused FD3D step: the CUDA kernel or the plain version.

``fd3d_step(u, u_prev, c2dt2, dx=...)`` is what the seismic substrate calls.
A CUDA tensor takes the hand-written kernel (``fd3d.fd3d_cuda``), a CPU
tensor the plain PyTorch version (``ref``).  ``backend="ref"`` asks for the
plain version on any device, for comparisons.  The kernel has no tile
constraint, so unlike the Pallas op there is no ``bz``.
"""

from __future__ import annotations

import torch

from . import ref
from .fd3d import fd3d_cuda

__all__ = ["fd3d_step"]


def fd3d_step(
    u: torch.Tensor,
    u_prev: torch.Tensor,
    c2dt2: torch.Tensor,
    *,
    dx: float,
    backend: str | None = None,
) -> torch.Tensor:
    if backend == "ref" or (backend is None and not u.is_cuda):
        return ref.fd3d_step(u, u_prev, c2dt2, dx)
    if backend is None:
        return fd3d_cuda(u, u_prev, c2dt2, dx=dx)
    raise ValueError(f"unknown backend {backend!r}")
