"""Shared building blocks: parameter init, norms, MLPs, RoPE.

Parameters are plain nested dicts of tensors with the reference's tree
layout (``repro/models/layers.py``).  The logical-axis names the reference
keeps beside each leaf serve its sharding rules and come with the port's
parallel slice.  Every function here computes in the reference's dtypes and
order: f32 norms and rotary angles, the activation dtype everywhere else.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "param",
    "rms_norm",
    "dense",
    "swiglu",
    "geglu_mlp",
    "rope",
    "mrope",
    "softcap",
]


# Elements drawn per f32 temporary: 256 MiB at most, and never more than one
# layer's worth, so a stack's draw needs little beyond its stored result.
_DRAW_CHUNK = 1 << 26


def param(
    generator: torch.Generator | None,
    shape: tuple[int, ...],
    *,
    layers: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    scale: float | str = "fan_in",  # or a std
    init: str = "normal",
    device: torch.device,
) -> torch.Tensor:
    """One parameter of per-layer ``shape``, stacked ``[layers, *shape]`` when
    ``layers`` > 0.

    Draws a normal truncated at ±3 std in f32 from ``generator`` and stores
    it in ``dtype``: std is 1/sqrt(fan-in) (``shape[0]``) or the number
    given; ``init="zeros"`` gives zeros.  The draw goes in pieces of at most
    one layer and ``_DRAW_CHUNK`` elements, each widened to f32 only while
    it is drawn (a stack of moonshot's experts is 8.9 G elements).
    ``init="ones"`` gives ones.  On the ``meta`` device nothing is drawn
    (shapes only).  torch's generator never reproduces ``jax.random``'s
    bits: parity with the reference goes through
    ``repro_torch.models.bridge``.
    """
    full = (layers, *shape) if layers else tuple(shape)
    if device.type == "meta" or init == "zeros":
        return torch.zeros(full, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(full, dtype=dtype, device=device)
    if scale == "fan_in":
        std = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1.0)
    else:
        std = float(scale)
    out = torch.empty(full, dtype=dtype, device=device)
    flat = out.view(-1)
    step = min(math.prod(shape), _DRAW_CHUNK)
    for lo in range(0, flat.numel(), step):
        part = flat[lo : lo + step]
        v = part if dtype == torch.float32 else torch.empty(
            part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(v, 0.0, std, -3.0 * std, 3.0 * std, generator=generator)
        if v is not part:
            part.copy_(v)
    return out


# ----------------------------------------------------------------- functional
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, scaled by ``1 + gamma`` (zero-initialised gammas)."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dt)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact.
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def swiglu(x, w_gate, w_up, w_down, act: str = "silu"):
    """Gated MLP: down( act(gate(x)) * up(x) )."""
    return dense(_act(act)(dense(x, w_gate)) * dense(x, w_up), w_down)


def geglu_mlp(x, w_in, w_down, act: str = "gelu"):
    """Gated MLP whose ``w_in`` packs [gate; up] along its output dim."""
    g, u = dense(x, w_in).chunk(2, dim=-1)
    return dense(_act(act)(g) * u, w_down)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------------- RoPE
def _freqs(dim: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)


def _apply_angles(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [..., dim] rotated by f32 angles [..., dim/2].

    The pairs are (x[i], x[i + dim/2]), the rotate-half layout, as in the
    reference's code (its docstring says "interleaved").
    """
    x1, x2 = x.chunk(2, dim=-1)
    c, s = torch.cos(ang), torch.sin(ang)
    dt = x.dtype
    x1, x2 = x1.float(), x2.float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE.  x [B, S, H, D]; positions [B, S]."""
    ang = positions[..., None].float() * _freqs(x.shape[-1], theta, x.device)  # [B, S, D/2]
    return _apply_angles(x, ang[:, :, None, :])


def mrope(
    x: torch.Tensor,
    positions: torch.Tensor,  # [3, B, S] (t, h, w) position ids
    theta: float,
    sections: tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: frequency bands split across t/h/w ids.

    ``sections`` partitions the HALF-dim (D/2) frequency channels; text tokens
    have t==h==w so M-RoPE degenerates to standard RoPE for them.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {d // 2}")
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)  # [D/2] which of t/h/w drives this channel
    pos_per_channel = positions.float()[sec_id]  # [D/2, B, S]
    ang = pos_per_channel.movedim(0, -1) * _freqs(d, theta, x.device)  # [B, S, D/2]
    return _apply_angles(x, ang[:, :, None, :])
