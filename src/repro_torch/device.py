"""Where the port's tensors live: on the card unless the caller asks for
another device, and never on the CPU in place of a missing card."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is false"
        )
    return dev
