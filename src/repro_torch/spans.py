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
"""

from __future__ import annotations

import contextlib

from torch.profiler import record_function

__all__ = ["span", "recording"]

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
