"""Plain PyTorch version of the 3-D acoustic FD time step (paper Eq. 12).

Second-order in time, 8th-order in space:

    u_next = 2 u - u_prev + (c dt)^2 * lap(u)

``lap`` is the 7-point-per-axis (radius-4) Laplacian.  This module is what
the CUDA kernel in ``fd3d.py`` is held against, on the CPU in the tests and
on the card in ``chip_smoke.py``; it runs every step on a CPU tensor.  The
summation order is the JAX reference's (``repro.kernels.fd3d.ref``): centre
term, then axis outer and k inner, then ``/ dx**2``.
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
