"""Carry a JAX parameter tree across as plain numpy.

The reference's checkpoint format (``repro/checkpoint/store.py``,
``_flatten``) turns a parameter tree into one flat dict of numpy arrays keyed
by ``/``-joined paths (``"groups/0/b0/attn/wq"``), with bf16 leaves widened
to f32, which is lossless.  :func:`params_from_flat` turns such a dict into
the port's tree on a device and dtype; :func:`flatten` is its inverse, for
comparing trees leaf by leaf.  This module imports no JAX: the caller
flattens.  Parity with the reference goes through here, never through the
two frameworks' random generators.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_flat", "flatten"]

# Leaves the reference stores in f32 whatever the model's dtype: the MoE
# router (``repro/models/moe.py``, ``moe_params``), the SSM's ``a_log`` and
# ``dt_bias`` (``ssm.py``, ``ssm_params``) and the RG-LRU's ``lam``
# (``rglru.py``, ``rglru_params``).
_F32_LEAVES = frozenset({"router", "a_log", "dt_bias", "lam"})


def params_from_flat(
    flat: Mapping[str, np.ndarray],
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Nested params from ``{"a/0/b": array}``: numeric path parts index
    lists, the others dict keys.  Floating leaves are cast to ``dtype``,
    except those the reference keeps in f32 (``_F32_LEAVES``), which stay
    f32 (so that routing reads the same logits, and the recurrences the
    same decay rates)."""
    dev = resolve_device(device)
    root: dict = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.dtype.kind not in "biuf":
            raise TypeError(f"{key}: leaf of dtype {arr.dtype}; widen it to f32 first")
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)  # a tensor needs memory it may own and write
        *parents, leaf = key.split("/")
        t = torch.from_numpy(arr)
        if t.is_floating_point():
            t = t.to(device=dev, dtype=torch.float32 if leaf in _F32_LEAVES else dtype)
        else:
            t = t.to(device=dev)
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return _lists(root)


def _lists(node):
    """Dicts keyed "0".."n-1" become lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"list indices {idx} are not 0..{len(idx) - 1}")
        return [out[k] for k in idx]
    return out


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``/``-joined paths to leaves, as the reference's ``_flatten`` keys
    them (list and tuple positions by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
