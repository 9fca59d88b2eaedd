"""Carry a seismic model across from the JAX package as plain numpy.

The JAX ``SeismicModel``'s fields, handed over as numpy arrays and Python
numbers (``np.asarray(m.velocity)``, ``m.dx``, ...), become the port's
``SeismicModel`` on ``device``.  This module imports no JAX: the caller does
the conversion to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import SeismicModel, resolve_device

__all__ = ["seismic_model_from_numpy"]


def seismic_model_from_numpy(
    velocity: np.ndarray,
    dx: float,
    dt: float,
    f_peak: float,
    sponge: int,
    sponge_decay: float,
    device: str | torch.device = "cuda",
) -> SeismicModel:
    """The port's model from the reference model's fields.

    The velocity is copied: the reference builds it with ``np.broadcast_to``,
    whose result is read-only and cannot back a tensor.
    """
    vel = np.array(velocity, dtype=np.float32, copy=True)
    if vel.ndim != 3:
        raise ValueError(f"velocity must be (NZ, NY, NX), got shape {vel.shape}")
    return SeismicModel(
        velocity=torch.from_numpy(vel).to(resolve_device(device)),
        dx=float(dx),
        dt=float(dt),
        f_peak=float(f_peak),
        sponge=int(sponge),
        sponge_decay=float(sponge_decay),
    )
