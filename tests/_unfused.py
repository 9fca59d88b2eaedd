"""The shot step's carry as separate PyTorch ops, as ``run_shot`` ran it
before the FD3D kernel took in its epilogue: the plain step (the kernel on a
CUDA tensor), the source ``add_``, ``u_next.mul_(mask)`` and the next
``u_prev = u.mul_(mask)``.  The fused launch and the fused ``run_shot`` are
held to these bit for bit, on the CPU and on the card."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fd3d import fd3d_step
from repro_torch.seismic import model as sm


def unfused_step(u, u_prev, c2dt2, dx, mask, src, amp):
    """One step from ``u_prev`` before its taper: ``u_prev`` is copied, so
    neither field is written."""
    u_next = fd3d_step(u, u_prev.clone().mul_(mask), c2dt2, dx=dx)
    u_next[tuple(src)].add_(amp)
    return u_next.mul_(mask)


def unfused_shot(model, src, receivers, nt: int) -> torch.Tensor:
    """The (nt, n_rec) seismogram of ``run_shot``'s unfused loop."""
    vel = model.velocity
    dev = vel.device
    nz, ny, nx = vel.shape
    c2dt2 = (vel * model.dt) ** 2
    mask = sm._sponge_mask((nz, ny, nx), model.sponge, model.sponge_decay, dev)
    sz, sy, sx = (int(v) for v in src)
    src_amp = sm.ricker(model.f_peak, model.dt, nt, dev) * c2dt2[sz, sy, sx]
    rec = torch.as_tensor(np.asarray(receivers, dtype=np.int64), device=dev)
    flat = (rec[:, 0] * ny + rec[:, 1]) * nx + rec[:, 2]
    u = torch.zeros_like(vel)
    u_prev = torch.zeros_like(vel)
    seis = torch.empty((nt, rec.shape[0]), dtype=vel.dtype, device=dev)
    for it in range(nt):
        u_next = fd3d_step(u, u_prev, c2dt2, dx=model.dx)
        u_next[sz, sy, sx].add_(src_amp[it])
        u_next.mul_(mask)
        u_prev = u.mul_(mask)
        seis[it] = u_next.view(-1)[flat]
        u = u_next
    return seis


def source_cells(shape) -> dict[str, tuple[int, int, int]]:
    """A source on an interior cell, a sponge cell (bottom face, y and x
    edges) and a corner of a field of ``shape``."""
    nz, ny, nx = shape
    return {"interior": (nz // 2, ny // 2, nx // 2),
            "sponge": (nz - 1, min(1, ny - 1), nx - 2 if nx > 1 else 0),
            "corner": (0, 0, 0)}
