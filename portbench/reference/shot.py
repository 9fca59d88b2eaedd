"""Plain PyTorch reference of one seismic shot, written from the equations
and independent of the port.

A shot propagates the 3-D acoustic wave equation with a second-order
leapfrog in time and an 8th-order (radius-4, 25-tap) star in space:

    u_next = 2 u - u_prev + (v dt)^2 * lap(u),

with zero values outside the grid.  After each step a Ricker wavelet,
scaled by (v dt)^2 at the source cell, is added at the source; ``u_next``
and the next ``u_prev`` (= ``u``) are multiplied by an exponential sponge
that absorbs near five faces (z = 0 is a free surface); the receivers read
``u_next``.  The reference derives (v dt)^2, the sponge and the wavelet from
the velocity and the settings itself.

It keeps one zero-padded copy of ``u`` and adds the 24 shifted neighbours
into the Laplacian in place, so a step moves ~40 bytes a cell and holds
six volumes.  Nothing here imports the port.
"""

from __future__ import annotations

import math

import torch

HALO = 4
C0 = -205.0 / 72.0  # centre weight of the 8th-order second derivative (Fornberg)
COEF = (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)


def ricker(f_peak: float, dt: float, nt: int, device) -> torch.Tensor:
    """The Ricker wavelet, peak at t = 1 / f_peak, in float32."""
    t = torch.arange(nt, dtype=torch.float64, device=device) * dt - 1.0 / f_peak
    a = (math.pi * f_peak * t) ** 2
    return ((1.0 - 2.0 * a) * torch.exp(-a)).float()


def sponge(shape: tuple[int, int, int], width: int, decay: float, device) -> torch.Tensor:
    """exp(-decay * (width - d)^2) within ``width`` cells of an absorbing
    face (d: the distance to it), 1 elsewhere; the product over the axes.
    The top face (z = 0) is free and does not absorb."""
    mask = torch.ones(shape, dtype=torch.float32, device=device)
    for axis, n in enumerate(shape):
        i = torch.arange(n, dtype=torch.float64, device=device)
        d = n - 1 - i if axis == 0 else torch.minimum(i, n - 1 - i)
        ramp = torch.where(d < width, torch.exp(-decay * (width - d) ** 2), torch.ones_like(d))
        view = [1, 1, 1]
        view[axis] = n
        mask = mask * ramp.float().view(view)
    return mask


def shot(velocity: torch.Tensor, src, receivers, nt: int, *, dx: float, dt: float,
         f_peak: float, width: int, decay: float, dtype=torch.float32) -> torch.Tensor:
    """The (nt, n_rec) seismogram of one shot, in ``dtype`` (float32; the
    control takes bfloat16), on ``velocity``'s device.  ``src`` is (z, y,
    x); ``receivers`` is a list of (z, y, x)."""
    dev = velocity.device
    nz, ny, nx = velocity.shape
    c2 = (velocity.float() * dt) ** 2  # (v dt)^2
    amp = (ricker(f_peak, dt, nt, dev) * c2[tuple(src)]).to(dtype)
    c2_dx2 = c2.div_(dx * dx).to(dtype)
    mask = sponge((nz, ny, nx), width, decay, dev).to(dtype)
    rec = torch.as_tensor(receivers, dtype=torch.long, device=dev)
    flat = (rec[:, 0] * ny + rec[:, 1]) * nx + rec[:, 2]
    padded = torch.zeros((nz + 2 * HALO, ny + 2 * HALO, nx + 2 * HALO), dtype=dtype, device=dev)
    inner = padded[HALO:-HALO, HALO:-HALO, HALO:-HALO]
    u = torch.zeros((nz, ny, nx), dtype=dtype, device=dev)
    u_prev = torch.zeros_like(u)
    lap = torch.empty_like(u)
    out = torch.empty((nt, len(receivers)), dtype=dtype, device=dev)
    for it in range(nt):
        inner.copy_(u)
        torch.mul(u, 3.0 * C0, out=lap)
        for axis in range(3):
            for k, c in enumerate(COEF, start=1):
                for sign in (-1, 1):
                    idx = [slice(HALO, HALO + n) for n in (nz, ny, nx)]
                    n = (nz, ny, nx)[axis]
                    idx[axis] = slice(HALO + sign * k, HALO + sign * k + n)
                    lap.add_(padded[tuple(idx)], alpha=c)
        u_next = lap.mul_(c2_dx2).add_(u, alpha=2.0).sub_(u_prev)
        u_next[tuple(src)] += amp[it]
        u_next.mul_(mask)
        u_prev, u, lap = u.mul_(mask), u_next, u_prev  # recycle the old u_prev as lap
        out[it] = u.view(-1)[flat]
    return out
