"""Fault-tolerant training driver: heartbeats, checkpoint/restart, elasticity.

Failure model (mapped from a real multi-host deployment to this container):

* worker failure mid-step  -> the A2WS runtime re-queues the dying worker's
  task and survivors steal the rest of its deque — the STEP still completes
  (no global restart for a single lost worker; this is the paper's
  decentralisation paying off as fault tolerance).
* persistent worker loss   -> the driver removes the worker between steps and
  rebuilds the task partition (elastic down-scale); a replacement can be
  added later (elastic up-scale) and preemptive stealing warms it up.
* process/job loss         -> periodic async checkpoints + restore-on-start;
  the synthetic data pipeline is step-indexed so resume is bit-exact.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


from repro_torch.checkpoint import store
from .het_dp import HetDPTrainer, WorkerFailed

__all__ = ["Heartbeat", "ResilientDriver"]


class Heartbeat:
    """Worker liveness tracking (timestamp board + stall detector)."""

    def __init__(self, num_workers: int, timeout: float = 5.0) -> None:
        self.last = [time.monotonic()] * num_workers
        self.timeout = timeout

    def beat(self, wid: int) -> None:
        self.last[wid] = time.monotonic()

    def stalled(self) -> list[int]:
        now = time.monotonic()
        return [i for i, t in enumerate(self.last) if now - t > self.timeout]


@dataclass
class DriverReport:
    steps_run: int
    restarts: int
    removed_workers: list[str]
    final_loss: float


class ResilientDriver:
    """Runs a HetDPTrainer for N steps with checkpoint/restart + elasticity."""

    def __init__(
        self,
        trainer: HetDPTrainer,
        make_microbatches,  # step -> list[dict]
        ckpt_dir: str,
        *,
        ckpt_every: int = 10,
    ) -> None:
        self.trainer = trainer
        self.make_microbatches = make_microbatches
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt = store.AsyncCheckpointer(ckpt_dir)
        self.removed: list[str] = []
        self.restarts = 0

    def _maybe_restore(self) -> int:
        step = store.latest_step(self.ckpt_dir)
        if step is None:
            return 0
        tree = {"params": self.trainer.params, "opt": self.trainer.opt_state}
        restored, _ = store.restore(self.ckpt_dir, tree, step=step)
        self.trainer.params = restored["params"]
        self.trainer.opt_state = restored["opt"]
        self.trainer.step_count = step
        return step

    def run(self, total_steps: int, *, resume: bool = True) -> DriverReport:
        start = self._maybe_restore() if resume else 0
        step = start
        last_loss = float("nan")
        while step < total_steps:
            mbs = self.make_microbatches(step)
            try:
                metrics = self.trainer.step(mbs)
            except WorkerFailed as e:
                # Catastrophic (all workers died): restart from checkpoint
                # with the failed worker removed.
                self.restarts += 1
                if 0 <= e.worker < len(self.trainer.workers):
                    self.removed.append(self.trainer.workers[e.worker].name)
                    self.trainer.remove_worker(e.worker)
                if not self.trainer.workers:
                    raise
                self._maybe_restore()
                step = self.trainer.step_count
                continue
            # Partial failure: the step completed; drop dead workers so the
            # next partition excludes them (elastic down-scale).
            for wid in sorted(metrics["failed_workers"], reverse=True):
                self.removed.append(self.trainer.workers[wid].name)
                self.trainer.remove_worker(wid)
            last_loss = metrics["loss"]
            step += 1
            if step % self.ckpt_every == 0 or step == total_steps:
                self.ckpt.save(
                    step,
                    {"params": self.trainer.params, "opt": self.trainer.opt_state},
                )
        self.ckpt.wait()
        return DriverReport(
            steps_run=step - start,
            restarts=self.restarts,
            removed_workers=self.removed,
            final_loss=last_loss,
        )
