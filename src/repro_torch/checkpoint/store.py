"""Checkpointing in the reference's on-disk format (``repro/checkpoint/store.py``).

Format: one ``ckpt_<step:08d>.npz`` per checkpoint step + a JSON manifest
beside it, each written to a temporary path and atomically renamed
(crash-safe).  Keys are the leaves' ``/``-joined paths (dict keys, list
positions), and bf16 leaves are widened to f32, which is lossless.  So a
checkpoint crosses between the packages in both directions: what the
reference saves the port restores, and the reverse.  ``restore`` loads
into the structure of a template tree, casting each leaf to the template
leaf's dtype and moving it to its device; with ``shardings`` (or a template
of DTensors) each leaf is cut to this rank's piece of the current mesh,
which is where elastic re-sharding happens: how the checkpoint was made
does not matter.  ``save`` takes whole tensors: gather a DTensor tree
(``full_tensor``, on every rank) before a rank writes it.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.bridge import flatten
from repro_torch.parallel.sharding import distribute, place

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]


def _host(leaf) -> np.ndarray:
    """A copy of a leaf as host numpy, bf16 and f8 (which numpy lacks)
    widened to f32."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16 or (t.is_floating_point() and t.element_size() == 1):
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _host(v) for k, v in flatten(tree).items()}


def save(directory: str, step: int, tree: Any, *, metadata: dict | None = None) -> str:
    """Atomic checkpoint write.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    final = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        **(metadata or {}),
    }
    mtmp = final + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, final + ".json")
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("ckpt_") : -len(".npz")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def restore(directory: str, template: Any, *, step: int | None = None, shardings=None):
    """Load a checkpoint into the structure of ``template`` (tensor leaves),
    each leaf cast to its template leaf's dtype and put on its device.

    ``shardings``: optional matching tree of ``NamedSharding`` for the
    CURRENT mesh; each leaf is laid out by it.  Without it a DTensor leaf
    of the template keeps the template's layout.  Returns (tree, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    shard = flatten(shardings) if shardings is not None else {}
    out = {}
    with np.load(path) as data:
        for k, t in flatten(template).items():
            full = torch.from_numpy(data[k]).to(device=t.device, dtype=t.dtype)
            if shard.get(k) is not None:
                full = place(full, shard[k])
            elif hasattr(t, "device_mesh"):  # a DTensor template leaf
                full = distribute(full, t.device_mesh, None, t.placements)
            out[k] = full
    return _fill(template, out), step


def _fill(tree, leaves: dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``tree``'s structure with the leaf at each path taken from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _fill(v, leaves, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


class AsyncCheckpointer:
    """Fire-and-forget background saver (one in flight at a time)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        self.wait()
        host_tree = _flatten(tree)  # snapshot on the host before the tree moves on

        def run():
            save(self.directory, step, host_tree, metadata=metadata)
            self.last_saved = step

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
