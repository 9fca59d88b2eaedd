"""Gradient compression for cross-group (slow-link) reduction, as in
``repro/runtime/compression.py``.

int8 per-tensor quantisation with **error feedback**: the residual of each
compression round is added back before the next one, so the bias vanishes
and SGD-style convergence is preserved (Karimireddy et al., 2019).  Over
trees of tensors, on their device: ``q`` is an int8 tensor and ``scale`` a
Python float, each equal to the reference's bit for bit (the maximum
magnitude over 127 in double precision; the quotient, ``rint`` and clip in
f32).
"""

from __future__ import annotations

import torch

from repro_torch.autodiff import tree_leaves, tree_map, tree_unflatten

__all__ = ["quantize", "dequantize", "ErrorFeedback", "compressed_bytes"]


def _f32(scale: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor on the device: a Python divisor is a reciprocal times
    # the dividend on the card, not the quotient numpy takes
    return torch.tensor(scale, dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    xf = x.detach().float()
    scale = float(xf.abs().max()) / 127.0 if xf.numel() else 0.0
    if scale == 0.0:
        return torch.zeros(xf.shape, dtype=torch.int8, device=xf.device), 0.0
    q = torch.clamp(torch.round(xf / _f32(scale, xf)), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q.float() * _f32(scale, q)


def compressed_bytes(tree) -> int:
    return sum(x.numel() + 4 for x in tree_leaves(tree))


def _is_packed(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0])
            and x[0].dtype == torch.int8)


class ErrorFeedback:
    """Per-link error-feedback compressor over a gradient tree."""

    def __init__(self) -> None:
        self._residual = None

    def compress(self, grads):
        """Returns the tree of ``(q, scale)`` pairs, updating the residual."""
        if self._residual is None:
            self._residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        corrected = tree_leaves(tree_map(lambda g, r: g.float() + r, grads, self._residual))
        packed = [quantize(c) for c in corrected]
        self._residual = tree_unflatten(grads, [c - dequantize(*p)
                                                for c, p in zip(corrected, packed)])
        return tree_unflatten(grads, packed)

    @staticmethod
    def decompress(packed):
        """The tree of f32 tensors that ``packed``'s pairs stand for."""
        if _is_packed(packed):
            return dequantize(*packed)
        if isinstance(packed, dict):
            return {k: ErrorFeedback.decompress(v) for k, v in packed.items()}
        return type(packed)(ErrorFeedback.decompress(v) for v in packed)
