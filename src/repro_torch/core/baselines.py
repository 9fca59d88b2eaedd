"""Literature baselines the paper compares against (§4) — as policy shims.

* **LW** — "Leader and Workers": classical centralized dynamic scheduling.
  The central queue lives on worker 0 (the leader is co-located, Fig. 5b):
  worker 0 is slowed by ``leader_overhead`` and every other worker requests
  one task at a time through a serialized leader gate (``service_time`` per
  request), which congests as the node count grows (§4: "the primary node
  ... becomes increasingly overloaded").

* **CTWS** — Cyclic Token-based Work-Stealing (Assis et al., 2019).  A single
  token circulates the ring carrying the global task-count vector; only the
  token holder may steal, it steals **half** the most-loaded victim's
  available tasks, and deadlock/race freedom comes from the token's
  exclusivity.  The cost is waiting for the token, which grows with the node
  count — the effect the paper beats.

Since PR 2 both are thin wrappers over the shared ``WorkerPool`` substrate
(``repro.core.a2ws``) parameterised by ``LWPolicy``/``CTWSPolicy``
(``repro.core.policy``): the worker loops, deques, submit()/drain() open
arrivals and latency telemetry are the substrate's, so the comparison
isolates the scheduling policy — and the baselines gain everything the
substrate grows (open arrivals, fault tombstones, ServePool serving).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

from .a2ws import WorkerPool
from .policy import CTWSPolicy, LWPolicy

__all__ = ["LWRuntime", "CTWSRuntime"]


class LWRuntime(WorkerPool):
    """Centralized leader–workers scheduler on the shared substrate."""

    def __init__(
        self,
        tasks: Sequence,
        num_workers: int,
        task_fn: Callable[[int, object], object],
        *,
        leader_overhead: float = 0.0,
        service_time: float = 0.0,
        request_rtt: float = 0.0,
        clock: Callable[[], float] = time.perf_counter,
        **kw,
    ) -> None:
        """``leader_overhead``: fractional slowdown applied to worker 0's task
        execution (the co-located leader thread steals cycles).
        ``service_time``: leader-side seconds consumed per request (models the
        serialization bottleneck at large worker counts).
        ``request_rtt``: request/grant wire round-trip per dispatch."""
        super().__init__(
            tasks,
            num_workers,
            task_fn,
            policy=LWPolicy(
                leader_overhead=leader_overhead,
                service_time=service_time,
                request_rtt=request_rtt,
            ),
            clock=clock,
            **kw,
        )


class CTWSRuntime(WorkerPool):
    """Cyclic token-based work-stealing on the shared substrate."""

    def __init__(
        self,
        tasks: Sequence,
        num_workers: int,
        task_fn: Callable[[int, object], object],
        *,
        token_hop_time: float = 0.0,
        clock: Callable[[], float] = time.perf_counter,
        **kw,
    ) -> None:
        """``token_hop_time``: per-node token transfer cost — the token
        carries the global P-sized count vector, so the effective hop gate is
        ``token_hop_time * num_workers`` (scales with the node count)."""
        super().__init__(
            tasks,
            num_workers,
            task_fn,
            policy=CTWSPolicy(
                num_workers, hop_time=token_hop_time * num_workers
            ),
            clock=clock,
            **kw,
        )
