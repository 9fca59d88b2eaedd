"""Heterogeneous data parallelism scheduled by A2WS, as in
``repro/runtime/het_dp.py`` — the paper's technique as a first-class
training feature.

The global batch of one optimizer step is split into T microbatch *tasks*.
Worker groups (here threads sharing one device, with configurable slowdown
factors standing in for heterogeneous hardware or stragglers) own A2WS
deques of those tasks.  Fast groups finish their microbatches and *steal*
from slow ones — Algorithm 1 verbatim, payload = microbatch index.  Because
every microbatch is the same token count, the combined gradient is the
exact full-batch gradient regardless of who computed what (asserted by
tests), so A2WS changes step *latency*, never semantics.

On a card each worker runs its microbatches on a CUDA stream of its own, and
its task returns only once that stream has finished: ``WorkerPool`` prices
tasks by their host-timed duration.  Each worker sums its gradients into an
accumulator on the device, in the parameters' dtype and in the order its
tasks ran, as the reference sums them on the host; the combine reads the
accumulators after every worker's stream has finished, adding them in
worker order on the default stream.

Cross-group gradient combination optionally goes through int8+error-feedback
compression (``repro_torch.runtime.compression``) — the slow-link trick for
cross-pod reduction.

Straggler mitigation and elasticity fall out of the scheduler: a slowed
worker's queue is drained by thieves (per-step), and workers can be added or
removed between steps (the task partition is rebuilt each step).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.autodiff import tree_leaves, tree_map, value_and_grad
from repro_torch.core.a2ws import RunStats, WorkerPool
from repro_torch.core.policy import SchedPolicy
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from .compression import ErrorFeedback

__all__ = ["WorkerSpec", "HetDPTrainer", "WorkerFailed"]


@dataclass
class WorkerSpec:
    name: str
    slow_factor: float = 1.0  # simulated heterogeneity (1.0 = full speed)
    fail_at_step: int | None = None  # fault-injection hook


class WorkerFailed(RuntimeError):
    def __init__(self, worker: int):
        super().__init__(f"worker {worker} failed")
        self.worker = worker


class HetDPTrainer:
    """A2WS-scheduled gradient-accumulation trainer over worker groups."""

    def __init__(
        self,
        loss_fn,  # loss_fn(params, microbatch) -> (loss, metrics)
        params,
        workers: list[WorkerSpec],
        opt_cfg: AdamWConfig = AdamWConfig(),
        *,
        radius: int | None = None,
        policy: str | SchedPolicy = "a2ws",
        compress: bool = False,
        base_task_time: float = 0.0,  # extra per-task sleep (demo pacing)
    ) -> None:
        """``policy``: scheduling policy for the per-step microbatch pool —
        "a2ws" (default), "ctws", "lw", "random", or a ``SchedPolicy``
        instance (reused across steps; name specs build one per step).

        The trainer owns ``params`` and its optimizer state: each step's
        AdamW update writes into them (``adamw_update`` works in place)."""
        self.params = params
        self.opt_cfg = opt_cfg
        self.opt_state = adamw_init(params, opt_cfg)
        self.workers = list(workers)
        self.radius = radius
        self.policy = policy
        self.compress = compress
        self.base_task_time = base_task_time
        self._grad_fn = value_and_grad(loss_fn)
        self._ef = [ErrorFeedback() for _ in workers]
        self.step_count = 0
        self.history: list[RunStats] = []

    # ------------------------------------------------------------------ step
    def step(self, microbatches: list[dict], lr_scale: float = 1.0):
        """One optimizer step over T microbatch tasks (dicts of tensors on
        the parameters' device)."""
        combined, metrics = self.gradient(microbatches)
        self.params, self.opt_state, om = adamw_update(
            combined, self.opt_state, self.params, self.opt_cfg, lr_scale
        )
        del combined
        self.step_count += 1
        return dict(metrics, grad_norm=float(om["grad_norm"]))

    def gradient(self, microbatches: list[dict]):
        """The pool's part of :meth:`step`: (the combined gradient, the
        step's metrics but ``grad_norm``), the parameters left as they are.
        The gradient is the mean over the microbatches, whoever ran them,
        in f32 where the parameters are bf16 (as the reference's)."""
        nw = len(self.workers)
        grads = [None] * nw
        losses = [0.0] * nw
        counts = [0] * nw
        locks = [threading.Lock() for _ in range(nw)]
        params = self.params
        step_idx = self.step_count
        dev = tree_leaves(params)[0].device
        streams = None
        if dev.type == "cuda":
            # made on this thread, each after the default stream's work so far
            # (the parameters' last update, the microbatches' copies, and the
            # last step's reads of memory the allocator may hand out again)
            streams = [torch.cuda.Stream(dev) for _ in range(nw)]
            for s in streams:
                s.wait_stream(torch.cuda.current_stream(dev))

        def run(wid: int, mb: dict):
            (loss, _), g = self._grad_fn(params, mb)
            with locks[wid]:
                if grads[wid] is None:  # the accumulator: memory of its own
                    grads[wid] = tree_map(torch.Tensor.contiguous, g)
                else:  # in the parameters' dtype, as the reference's host sum
                    tree_map(torch.Tensor.add_, grads[wid], g)
            return float(loss)

        def task_fn(wid: int, task_idx):
            spec = self.workers[wid]
            if spec.fail_at_step is not None and step_idx >= spec.fail_at_step:
                raise WorkerFailed(wid)
            mb = microbatches[int(task_idx)]
            if streams is None:
                loss = run(wid, mb)
            else:
                with torch.cuda.stream(streams[wid]):
                    loss = run(wid, mb)
                    streams[wid].synchronize()
            if spec.slow_factor > 1.0 or self.base_task_time:
                time.sleep(self.base_task_time * max(spec.slow_factor, 1.0))
            with locks[wid]:
                losses[wid] += loss
                counts[wid] += 1

        rt = WorkerPool(
            list(range(len(microbatches))),
            nw,
            task_fn,
            policy=self.policy,
            radius=self.radius,
            seed=self.step_count,
        )
        stats = rt.run()
        self.history.append(stats)

        # ----------------------------------------------- combine + update
        total = sum(counts)
        failed = sorted({wid for wid, _, _ in rt.errors})
        if total < len(microbatches):
            # Only possible if every worker died: surviving workers steal the
            # re-queued tasks of dead ones, so partial failure still finishes.
            raise WorkerFailed(failed[0] if failed else -1)
        combined = None
        for wid in range(nw):
            g, grads[wid] = grads[wid], None  # each accumulator freed once added
            if g is None:
                continue
            if self.compress:
                packed = self._ef[wid].compress(g)
                g = ErrorFeedback.decompress(packed)
            if combined is None:
                combined = g
            else:
                tree_map(torch.Tensor.add_, combined, g)
            del g
        # the mean, as the reference divides its host sums: a bf16 array over
        # an int is f32 there, so a bf16 sum becomes an f32 gradient
        n = torch.tensor(total, dtype=torch.float32, device=dev)
        combined = tree_map(
            lambda x: (x.float() if x.dtype == torch.bfloat16 else x).div_(n), combined)
        return combined, {
            "loss": sum(losses) / max(total, 1),
            "tasks_per_worker": counts,
            "steals": len(stats.steals),
            "makespan": stats.makespan,
            "failed_workers": failed,
        }

    # ------------------------------------------------------------- elasticity
    def remove_worker(self, wid: int) -> None:
        del self.workers[wid]
        del self._ef[wid]

    def add_worker(self, spec: WorkerSpec) -> None:
        self.workers.append(spec)
        self._ef.append(ErrorFeedback())
