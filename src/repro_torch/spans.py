"""Named spans of the port's work, on the profiler's clock.

``span(name)`` marks a region of host code with
``torch.profiler.record_function`` while recording is on, so a profiler
run over the work puts the program's spans on the same clock as the device
operations they launch.  A span nests inside the span open around it on
its own thread.  With recording off, ``span`` returns one shared no-op
context: a span site costs one check of a module-level flag.

The flag is the program's own, not the profiler's: a profiler started
with ``profile_all_threads`` records the spans of worker threads, on which
``torch.autograd._profiler_enabled()`` still reads false.  Turn it on with
``recording()``, around the profiler's run::

    with repro_torch.spans.recording(), torch.profiler.profile(...):
        ...

A :class:`Counter` counts always, recording or not: a sum kept where its
values are, on the device for a device tensor, read once (``read``) after
the work it counts.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.profiler import record_function

__all__ = ["span", "recording", "Counter"]

_recording = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while recording is on."""
    return record_function(name) if _recording else _OFF


@contextlib.contextmanager
def recording():
    """Record spans, on every thread, inside this context."""
    global _recording
    prev, _recording = _recording, True
    try:
        yield
    finally:
        _recording = prev


class Counter:
    """A sum that counting never waits for.

    ``add(value)`` takes a Python number (summed on the host) or a tensor
    (summed where it lies, in int64 or float64: no host read).  Each CUDA
    stream, and on the CPU each thread, adds into a sum of its own, so that
    worker threads on streams of their own never add into one memory
    location at once.  Adds made while autograd recomputes a checkpointed
    forward (inside a backward pass) are skipped, so a rematerialised layer
    counts once; so are adds of fake or ``meta`` tensors (a dry run's).
    ``read()`` waits for the devices it holds sums on and returns the
    total; ``reset()`` starts again from 0."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._host = 0
        self._sums: dict = {}

    def add(self, value) -> None:
        if torch._C._current_graph_task_id() != -1:  # a backward's recompute
            return
        if not torch.is_tensor(value):
            with self._lock:
                self._host += value
            return
        from torch._subclasses.fake_tensor import is_fake

        dev = value.device
        if dev.type == "meta" or is_fake(value):
            return
        dtype = torch.float64 if value.is_floating_point() else torch.int64
        where = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" \
            else threading.get_ident()
        key = (dev, where, dtype)
        with self._lock:
            total = self._sums.get(key)
            if total is None:
                total = self._sums[key] = torch.zeros((), dtype=dtype, device=dev)
        if value.requires_grad:
            value = value.detach()
        if value.dim():
            value = value.sum()
        total.add_(value if value.dtype == dtype else value.to(dtype))

    def read(self):
        """The total so far (one host read a device, after its work)."""
        with self._lock:
            sums = list(self._sums.items())
            out = self._host
        for dev in {k[0] for k, _ in sums if k[0].type == "cuda"}:
            torch.cuda.synchronize(dev)
        for _, t in sums:
            out += t.item()
        return out

    def reset(self) -> None:
        with self._lock:
            self._host = 0
            self._sums = {}
