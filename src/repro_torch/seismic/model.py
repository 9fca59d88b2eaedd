"""3-D acoustic seismic modeling — the paper's use case (§3).

A *shot* is one independent simulation: inject a Ricker source at a position
near the surface, propagate Eq. 12 for ``nt`` steps through the velocity
model, and record the pressure at receiver positions.  Shots are the
homogeneous tasks A2WS schedules.

The stencil is the FD3D op (``repro_torch.kernels.fd3d``): the CUDA kernel
for a CUDA model, the plain PyTorch version for a CPU one.  Boundaries use a
simple exponential sponge taper.  The shot loop is a Python loop over ``nt``
steps, which enqueues its work on the current CUDA stream without waiting
for it; the caller synchronises.  Tensors are made on ``device="cuda"``
unless the caller asks for another device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.fd3d import fd3d_step
from repro_torch.kernels.fd3d.ref import taper_mask
from repro_torch.spans import span

__all__ = [
    "Shot", "SeismicModel", "ricker", "run_shot", "make_demo_model",
    "make_shot_grid", "resolve_device",
]


def ricker(
    f_peak: float, dt: float, nt: int, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """Ricker wavelet source time function, float32."""
    t = torch.arange(nt, dtype=torch.float32, device=resolve_device(device)) * dt
    t = t - 1.0 / f_peak
    a = (np.pi * f_peak * t) ** 2
    return (1.0 - 2.0 * a) * torch.exp(-a)


@dataclass(frozen=True)
class Shot:
    """One seismic experiment: source position + receiver line."""

    src: tuple[int, int, int]
    receivers: tuple[tuple[int, int, int], ...]

    def rec_array(self) -> np.ndarray:
        return np.asarray(self.receivers, dtype=np.int32)


@dataclass(frozen=True)
class SeismicModel:
    """Discretised velocity model + solver settings."""

    velocity: torch.Tensor  # (NZ, NY, NX) m/s, on the model's device
    dx: float = 10.0  # m
    dt: float = 1e-3  # s  (must satisfy CFL: dt < 0.4 dx / vmax)
    f_peak: float = 12.0  # Hz
    sponge: int = 8
    sponge_decay: float = 0.012

    def cfl_ok(self) -> bool:
        vmax = float(self.velocity.max())
        return self.dt <= 0.5 * self.dx / (vmax * np.sqrt(3.0) / 2.0)


def _sponge_ramps(
    shape: tuple[int, int, int],
    width: int,
    decay: float,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sponge's 1-D ramps ``(mz, my, mx)``, float32: an exponential
    absorbing taper near five faces (z=0 is the free surface, where sources
    and receivers live).  The 3-D taper is ``(mz * my) * mx``."""
    dev = resolve_device(device)
    ramps = []
    for axis, n in enumerate(shape):
        idx = torch.arange(n, device=dev)
        if axis == 0:  # free surface at z=0: only absorb at the bottom
            edge = n - 1 - idx
        else:
            edge = torch.minimum(idx, n - 1 - idx)
        sq = ((width - edge) ** 2).to(torch.float32)
        ramp = torch.where(edge < width, torch.exp(-decay * sq), 1.0)
        ramps.append(ramp.to(torch.float32))
    return tuple(ramps)


def _sponge_mask(
    shape: tuple[int, int, int],
    width: int,
    decay: float,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The 3-D sponge taper, float32: the product of ``_sponge_ramps``."""
    return taper_mask(*_sponge_ramps(shape, width, decay, device))


def run_shot(
    model: SeismicModel,
    src: Sequence[int],  # (z, y, x)
    receivers: Sequence[Sequence[int]] | np.ndarray,  # (n_rec, 3)
    nt: int,
    backend: str | None = None,
) -> torch.Tensor:
    """Propagate one shot; returns the (nt, n_rec) seismogram on the model's
    device.  The work is enqueued on the current stream; synchronise it
    before reading the result's time.

    The carry is the JAX loop's exactly: the source is added after the step,
    scaled by ``c2dt2`` at the source cell; the mask multiplies ``u_next``;
    the next ``u_prev`` is ``u * mask``; receivers are read from ``u_next``.
    Each step is one ``fd3d_step`` with the sponge's three 1-D ramps, the
    source cell and its amplitude: on the card one launch that multiplies
    ``u_prev`` by the mask as it loads it, adds the source, multiplies by
    the mask and stores, rounding to the field's dtype after each in that
    order, so the seismogram is the separate ops' bit for bit.  ``u_prev``
    is therefore kept as the previous ``u``, before its second taper.  No
    3-D mask is made.

    Spans (``repro_torch.spans``): ``shot.setup`` around the shot's set-up,
    ``shot.steps`` around the launch loop (none per step: a host span
    around asynchronous launches would time the enqueue, not the step).
    """
    vel = model.velocity
    dev = vel.device
    nz, ny, nx = vel.shape
    with span("shot.setup"):
        c2dt2 = (vel * model.dt) ** 2
        taper = _sponge_ramps((nz, ny, nx), model.sponge, model.sponge_decay, dev)
        wavelet = ricker(model.f_peak, model.dt, nt, dev)
        sz, sy, sx = (int(v) for v in src)
        src_amp = wavelet * c2dt2[sz, sy, sx]
        rec = torch.as_tensor(np.asarray(receivers, dtype=np.int64), device=dev)
        rec_flat = (rec[:, 0] * ny + rec[:, 1]) * nx + rec[:, 2]
        u = torch.zeros_like(vel)
        u_prev = torch.zeros_like(vel)
        seis = torch.empty((nt, rec.shape[0]), dtype=vel.dtype, device=dev)
    with span("shot.steps"):
        for it in range(nt):
            u_next = fd3d_step(u, u_prev, c2dt2, dx=model.dx, taper=taper,
                               src=(sz, sy, sx), amp=src_amp[it], backend=backend)
            seis[it] = u_next.view(-1)[rec_flat]
            u_prev, u = u, u_next
    return seis


def make_demo_model(
    n: int = 48,
    dx: float = 10.0,
    dt: float = 1e-3,
    layers: int = 3,
    device: str | torch.device = "cuda",
) -> SeismicModel:
    """Layered-earth model: an ``n``^3 cube of ``layers`` velocity bands."""
    z = np.linspace(0, 1, n)[:, None, None]
    vel = 1500.0 + 1000.0 * np.floor(z * layers)
    vel = np.broadcast_to(vel, (n, n, n)).astype(np.float32)
    return SeismicModel(
        velocity=torch.from_numpy(vel).to(resolve_device(device)), dx=dx, dt=dt
    )


def make_shot_grid(
    model: SeismicModel, num_shots: int, depth: int = 2, n_rec: int = 8
) -> list[Shot]:
    """A line of shots across the surface with a fixed receiver line."""
    nz, ny, nx = model.velocity.shape
    xs = np.linspace(6, nx - 7, num_shots).astype(int)
    rec_y = ny // 2
    recs = tuple(
        (depth, rec_y, int(x)) for x in np.linspace(4, nx - 5, n_rec).astype(int)
    )
    return [Shot(src=(depth, rec_y, int(x)), receivers=recs) for x in xs]
