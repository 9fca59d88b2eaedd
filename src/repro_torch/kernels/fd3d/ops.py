"""Public op for the fused FD3D step: the CUDA kernel or the plain version.

``fd3d_step(u, u_prev, c2dt2, dx=...)`` is what the seismic substrate calls.
A CUDA tensor takes the hand-written kernel (``fd3d.fd3d_cuda``), a CPU
tensor the plain PyTorch version (``ref``).  ``backend="ref"`` asks for the
plain version on any device, for comparisons.  The kernel has no tile
constraint, so unlike the Pallas op there is no ``bz``.

With ``taper=(mz, my, mx)``, ``src=(sz, sy, sx)`` and ``amp`` (a 0-d fp32
tensor, e.g. ``src_amp[it]``: a view, so passing it syncs nothing) the step
also carries a shot's epilogue: ``u_prev`` is taken times the taper
``(mz * my) * mx``, ``amp`` is added at the source cell and the result is
returned times the taper, rounded to the field's dtype after each.  On the
card that is one launch; on the CPU, or with ``backend="ref"``, it is
``ref.fd3d_step_tapered``'s separate ops, with the same bits.
"""

from __future__ import annotations

import torch

from . import ref
from .fd3d import check_epilogue, fd3d_cuda

__all__ = ["fd3d_step"]


def fd3d_step(
    u: torch.Tensor,
    u_prev: torch.Tensor,
    c2dt2: torch.Tensor,
    *,
    dx: float,
    taper: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    src: tuple[int, int, int] | None = None,
    amp: torch.Tensor | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    if backend == "ref" or (backend is None and not u.is_cuda):
        check_epilogue(u, taper, src, amp)
        if taper is None:
            return ref.fd3d_step(u, u_prev, c2dt2, dx)
        return ref.fd3d_step_tapered(u, u_prev, c2dt2, dx, taper, src, amp)
    if backend is None:
        return fd3d_cuda(u, u_prev, c2dt2, dx=dx, taper=taper, src=src, amp=amp)
    raise ValueError(f"unknown backend {backend!r}")
