"""Plain PyTorch version of the 3-D acoustic FD time step (paper Eq. 12).

Second-order in time, 8th-order in space:

    u_next = 2 u - u_prev + (c dt)^2 * lap(u)

``lap`` is the 7-point-per-axis (radius-4) Laplacian.  This module is what
the CUDA kernel in ``fd3d.py`` is held against, on the CPU in the tests and
on the card in ``chip_smoke.py``; it runs every step on a CPU tensor.  The
summation order is the JAX reference's (``repro.kernels.fd3d.ref``): centre
term, then axis outer and k inner, then ``/ dx**2``.

``fd3d_step_tapered`` is the plain counterpart of the kernel's launch with
the shot step's epilogue: the step, the source add and the sponge taper as
separate PyTorch ops, which that launch matches bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 8th-order central second-derivative coefficients (Fornberg).
C0 = -205.0 / 72.0
COEF = (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)
HALO = 4


def laplacian(u: torch.Tensor, dx: float) -> torch.Tensor:
    """Radius-4 Laplacian with zero (Dirichlet) boundaries, same shape."""
    up = F.pad(u, (HALO,) * 6)
    out = 3.0 * C0 * u
    for axis in range(3):
        for k, c in enumerate(COEF, start=1):
            lo = [slice(HALO, -HALO)] * 3
            hi = [slice(HALO, -HALO)] * 3
            lo[axis] = slice(HALO - k, up.shape[axis] - HALO - k)
            hi[axis] = slice(HALO + k, up.shape[axis] - HALO + k)
            out = out + c * (up[tuple(lo)] + up[tuple(hi)])
    return out / (dx * dx)


def fd3d_step(
    u: torch.Tensor, u_prev: torch.Tensor, c2dt2: torch.Tensor, dx: float
) -> torch.Tensor:
    """One leapfrog time step of Eq. 12 (without the source injection)."""
    return 2.0 * u - u_prev + c2dt2 * laplacian(u, dx)


def taper_mask(mz: torch.Tensor, my: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """The 3-D taper of three 1-D ramps, formed as ``(mz * my) * mx`` in the
    ramps' dtype: the product, and rounding, that the kernel forms a cell."""
    return mz[:, None, None] * my[None, :, None] * mx[None, None, :]


def fd3d_step_tapered(
    u: torch.Tensor,
    u_prev: torch.Tensor,
    c2dt2: torch.Tensor,
    dx: float,
    taper: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    src: tuple[int, int, int],
    amp: torch.Tensor,
) -> torch.Tensor:
    """One step of a shot's carry: the step from ``u`` and ``u_prev * mask``
    (rounded to ``u_prev``'s dtype, as an in-place multiply stores it), then
    ``amp`` added at ``src``, then the result times the mask, each in place
    in the field's dtype.  ``u_prev`` is not written."""
    mask = taper_mask(*taper)
    u_next = fd3d_step(u, (u_prev * mask).to(u_prev.dtype), c2dt2, dx)
    u_next[tuple(src)].add_(amp)
    return u_next.mul_(mask)
