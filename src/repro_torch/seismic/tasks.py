"""Shots as A2WS tasks: the ``task_fn`` a ``WorkerPool`` runs on each worker.

Every worker thread shares the model's device.  On a card each worker runs
its shots on a CUDA stream of its own, so shots of different workers
overlap on the device, and ``task_fn`` returns only once that stream has
finished the shot: ``WorkerPool`` prices work by the host-timed duration of
``task_fn`` (the info ring's per-task runtimes), so a task that returned at
enqueue would feed the steal equations launch times instead of shot times.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .model import SeismicModel, Shot, run_shot

__all__ = ["make_shot_task"]


def make_shot_task(
    model: SeismicModel,
    nt: int,
    num_workers: int,
    results: dict[tuple[int, int, int], np.ndarray],
    backend: str | None = None,
) -> Callable[[int, Shot], None]:
    """``task_fn(wid, shot)``: run ``shot`` for ``nt`` steps on worker
    ``wid`` and store its (nt, n_rec) seismogram in ``results[shot.src]``.

    Make the model's tensors, synchronise, then call this before the pool
    starts: the streams are created here, one per worker.
    """
    dev = model.velocity.device
    streams = (
        [torch.cuda.Stream(dev) for _ in range(num_workers)]
        if dev.type == "cuda" else None
    )

    def task_fn(wid: int, shot: Shot) -> None:
        if streams is None:
            seis = run_shot(model, shot.src, shot.rec_array(), nt, backend)
            results[shot.src] = seis.numpy()
            return
        stream = streams[wid]
        with torch.cuda.stream(stream):
            seis = run_shot(model, shot.src, shot.rec_array(), nt, backend)
            stream.synchronize()
            results[shot.src] = seis.cpu().numpy()

    return task_fn
