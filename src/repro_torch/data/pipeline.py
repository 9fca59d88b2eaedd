"""Deterministic synthetic token pipeline with host sharding and prefetch.

Real text is unavailable offline, so the stream is a splittable counter-based
PRNG over token ids with a Zipf-ish marginal — deterministic per (seed, step,
shard), which makes multi-host loading, checkpoint-resume and elastic
re-sharding exact: a worker joining at step k produces the same global batch
content as the worker it replaced.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0


class SyntheticLM:
    """Deterministic synthetic LM batches (tokens, labels)."""

    def __init__(self, cfg: DataConfig) -> None:
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        base_row = step * cfg.global_batch + self.local_batch * cfg.shard
        for r in range(self.local_batch):
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed, counter=[0, 0, step, base_row + r])
            )
            # Zipf-ish marginal over the vocab, cheap to sample:
            u = rng.random(cfg.seq_len + 1)
            toks = (cfg.vocab * u**3).astype(np.int32) % cfg.vocab
            rows.append(toks)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, it, depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)

        self._th = threading.Thread(target=run, daemon=True)
        self._th.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
