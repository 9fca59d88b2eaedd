"""Policy-parametric threaded worker-pool substrate (+ A2WS Algorithm 1).

``WorkerPool`` is the **control plane** of the framework: worker threads (one
per heterogeneous worker group / node) execute opaque tasks and keep
per-worker deques (``repro.core.deque``); shared memory between threads
stands in for MPI RMA windows — the protocol (packed head/tail
get-accumulate, partitioned info Puts, preemptive wall-time speed estimates)
is the paper's, see DESIGN.md §2 for the adaptation argument.

WHICH tasks move, and when, is decided by a pluggable ``SchedPolicy``
(``repro.core.policy``): the paper's adaptive A2WS over the §2.1 info ring,
the CTWS token, the LW central leader, or classical random stealing — all on
this one substrate, so comparisons isolate the scheduling policy.  The
discrete-event simulator (``repro.core.simulator``) drives the SAME policy
objects under virtual time (DESIGN.md §Policy layer).

The pool is generic over the task payload: the seismic driver feeds shots,
the training runtime (``repro.runtime.het_dp``) feeds microbatches, the
server feeds request batches.

Two workload modes (DESIGN.md §Open-arrival), available to EVERY policy:

* **closed** (the paper's Algorithm 1): every task is known up front,
  statically partitioned (§2.2.1), and the run ends when the fixed task count
  has executed.
* **open-arrival** (``open_arrival=True``): tasks are injected with
  ``submit()`` while the run loop is live; ``drain()`` announces that no
  further tasks will arrive and termination is detected by quiescence —
  "my deque is empty" no longer means "the workload is finished".

Algorithm 1 mapping (line numbers from the paper; policy = A2WSPolicy):

    1  while the process has task do            -> _worker_loop
    2    update_process_info()                  -> _update_info
    3-8  if ran a task: S=steal_equation();     -> policy.on_boundary
         v=select_victim(S); steal_task(v,S)       + _policy_boundary
    10   T_id = get_task_id()                   -> deque.get_task
    11   update_process_info()                  -> _update_info
    12   execute(T_id)                          -> task_fn
    13   info_communication()                   -> RingInfo.communicate
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .deque import AtomicInt64, Task, TaskDeque, slo_key
from .info_ring import CellBoard, RingInfo
from .limp import (
    LimpConfig,
    LimpState,
    SlowdownSchedule,
    effective_heartbeat,
    normalize_duration,
)
from .netfault import NF_SEED_SALT, LinkHealth, NetFaultSchedule
from .policy import PolicyView, SchedPolicy, make_policy
from .steal import OverlayBuffers, class_counts, weighted_overlay
from .topology import Topology

__all__ = [
    "WorkerPool",
    "A2WSRuntime",
    "PoolCollapsed",
    "RunStats",
    "TaskRecord",
    "latency_percentiles",
    "partition_tasks",
]


class PoolCollapsed(RuntimeError):
    """``submit()`` into a pool with no live worker: nothing can ever run
    the task (every worker died or retired).  Distinct from the plain
    ``RuntimeError`` of submit-after-drain so servers can fail the one
    request instead of treating the pool as cleanly shut down."""


#: Default latency quantiles.  p99.9 rides along since the SLO plane — at
#: trace scale (10^6 requests) p99 hides the tail the SLO targets.
DEFAULT_QS = (50.0, 95.0, 99.0, 99.9)


def latency_percentiles(
    latencies: Sequence[float], qs: Sequence[float] = DEFAULT_QS
) -> dict[float, float]:
    """Per-task latency percentiles ({} when there are no samples) — shared
    by the threaded runtime's RunStats and the simulator's SimResult."""
    if not latencies:
        return {}
    vals = np.percentile(np.asarray(latencies, dtype=np.float64), list(qs))
    return {float(q): float(v) for q, v in zip(qs, vals)}


@dataclass
class TaskRecord:
    task: object
    worker: int
    start: float
    end: float
    arrival: float = float("nan")  # submit time (open-arrival); NaN = at boot

    @property
    def latency(self) -> float:
        """Arrival-to-completion sojourn time (open-arrival telemetry)."""
        return self.end - self.arrival


@dataclass
class RunStats:
    makespan: float
    records: list[TaskRecord]
    steals: list[tuple[float, int, int, int]]  # (time, thief, victim, amount)
    failed_steals: int
    info_cells_sent: int
    corrections: int
    per_worker_tasks: list[int] = field(default_factory=list)
    per_worker_mean_t: list[float] = field(default_factory=list)
    # Fault-fabric telemetry (DESIGN.md §Fault fabric); all zero when the
    # pool runs with netfaults=None.
    net_failed: int = 0  # steal requests lost to drops / partitions
    lease_expired: int = 0  # transfers returned to the victim on expiry
    fare_paid: float = 0.0  # total transport fare slept before loot landed

    @property
    def latencies(self) -> list[float]:
        """Per-task sojourn times for records with a known arrival time."""
        return [r.latency for r in self.records if r.arrival == r.arrival]

    def latency_percentiles(
        self, qs: Sequence[float] = DEFAULT_QS
    ) -> dict[float, float]:
        """Latency percentiles of the open-arrival run (empty dict if the run
        was closed — no arrival stamps to measure against)."""
        return latency_percentiles(self.latencies, qs)

    def slo_stats(self) -> dict[str, dict[str, float]]:
        """Per-SLO-class telemetry (DESIGN.md §SLO serving): task count,
        deadline violations + rate, and latency percentiles, keyed by class
        name.  Classes with no tasks are omitted; a run whose payloads carry
        no SLO attributes reports everything under ``"batch"``."""
        from .deque import SLO_NAMES, slo_of

        per: dict[str, dict[str, object]] = {}
        for r in self.records:
            s, d, _ = slo_of(r.task)
            b = per.setdefault(
                SLO_NAMES[s], {"count": 0, "violations": 0, "lats": []}
            )
            b["count"] += 1
            if r.end > d:
                b["violations"] += 1
            if r.arrival == r.arrival:
                b["lats"].append(r.latency)
        out: dict[str, dict[str, float]] = {}
        for name, b in per.items():
            pct = latency_percentiles(b["lats"])
            out[name] = {
                "count": float(b["count"]),
                "violations": float(b["violations"]),
                "violation_rate": b["violations"] / max(b["count"], 1),
                **{f"p{q:g}": v for q, v in pct.items()},
            }
        return out

    def summary(self) -> str:
        counts = ",".join(str(c) for c in self.per_worker_tasks)
        out = (
            f"makespan={self.makespan:.4f}s steals={len(self.steals)} "
            f"failed={self.failed_steals} cells={self.info_cells_sent} "
            f"tasks/worker=[{counts}]"
        )
        pct = self.latency_percentiles()
        if pct:
            out += " lat[p50/p95/p99/p99.9]=" + "/".join(
                f"{pct[q]*1e3:.1f}ms" for q in DEFAULT_QS
            )
        slo = self.slo_stats()
        if len(slo) > 1 or "latency" in slo:
            out += " slo[" + " ".join(
                f"{name}={int(b['violations'])}/{int(b['count'])}viol"
                for name, b in sorted(slo.items())
            ) + "]"
        return out


def partition_tasks(tasks: Sequence, num_workers: int) -> list[list]:
    """Static block partition used before execution starts (§2.2.1: "A2WS
    distributes the tasks statically just before execution starts")."""
    out: list[list] = [[] for _ in range(num_workers)]
    base, rem = divmod(len(tasks), num_workers)
    pos = 0
    for w in range(num_workers):
        k = base + (1 if w < rem else 0)
        out[w] = list(tasks[pos : pos + k])
        pos += k
    return out


class _WorkerState:
    __slots__ = (
        "deque", "executed", "runtime_sum", "ran_any", "start_time", "rng",
        "wake", "retiring", "drain_on_retire", "class_t", "nc_cache",
        "limp_state", "slow_mult", "overlay_buf", "nf_rng", "heal_idx",
    )

    def __init__(
        self,
        deque: TaskDeque,
        seed: int,
        num_classes: int = 1,
        limp_cfg: LimpConfig | None = None,
    ) -> None:
        self.deque = deque
        self.executed = 0
        self.runtime_sum = 0.0
        self.ran_any = False
        self.start_time = 0.0
        self.rng = np.random.default_rng(seed)
        # Straggler plane (DESIGN.md §Straggler plane): owner-side limp
        # detector (None = detection off) and the manually injected live
        # slowdown multiplier (set_worker_slowdown — fault injection).
        self.limp_state = LimpState(limp_cfg) if limp_cfg is not None else None
        self.slow_mult = 1.0
        # Per-cost-class EWMA runtime estimates t̂[c] (NaN = never ran one);
        # written only by the owner thread, published via the info ring.
        self.class_t = np.full(num_classes, np.nan, dtype=np.float64)
        # (mutations, headtail word) -> cached queue-composition scan; the
        # scan is O(queue) under a lock and sits on the per-boundary hot
        # path, so it must only re-run when the deque actually changed.
        self.nc_cache: tuple[tuple[int, int], np.ndarray] | None = None
        # Preallocated weighted-overlay scratch (steal.OverlayBuffers),
        # lazily keyed on the (view size, num_classes) this worker last saw —
        # per-worker, so reuse never races another boundary's view.
        self.overlay_buf: OverlayBuffers | None = None
        # Per-worker wake event: a submit()/drain()/death sets EVERY event,
        # but each worker clears only its OWN — a busy worker's clear can
        # therefore never erase a wakeup meant for an idle sleeper (the
        # lost-wakeup bug a single shared Event had).
        self.wake = threading.Event()
        self.retiring = False
        self.drain_on_retire = True
        # Fault plane (DESIGN.md §Fault fabric): dedicated message-drop rng
        # (derived from the worker seed so the SCHEDULING rng stream stays
        # bit-for-bit untouched) and the per-worker heal cursor into
        # NetFaultSchedule.heal_times() — advanced at the first boundary
        # after each partition heals, triggering ring resync.
        self.nf_rng: np.random.Generator | None = None
        self.heal_idx = 0


class WorkerPool:
    """Threaded executor for ``num_workers`` heterogeneous workers, load
    balanced by a pluggable scheduling policy."""

    def __init__(
        self,
        tasks: Sequence,
        num_workers: int,
        task_fn: Callable[[int, object], object],
        *,
        policy: str | SchedPolicy = "a2ws",
        radius: int | None = None,
        seed: int = 0,
        idle_backoff: float = 1e-4,
        idle_backoff_max: float | None = None,
        clock: Callable[[], float] = time.perf_counter,
        open_arrival: bool = False,
        cost_class_fn: Callable[[object], int] | None = None,
        num_classes: int = 1,
        ewma_alpha: float = 0.25,
        slowdown: SlowdownSchedule | None = None,
        limp: LimpConfig | None = None,
        topology: Topology | None = None,
        netfaults: NetFaultSchedule | None = None,
        slo: bool = False,
        slo_aging: float = math.inf,
    ) -> None:
        """``task_fn(worker_id, task) -> result`` runs the task on a worker.

        ``policy``: a ``SchedPolicy`` instance or registry name ("a2ws",
        "ctws", "lw", "random").  The policy decides steals at every task
        boundary; the pool owns deques, threads, termination and telemetry.

        ``radius`` defaults to the paper's operating point: 20% of the number
        of workers (Fig. 4 discussion), at least 1.  Only ring policies
        (``policy.uses_ring``) build the info board.

        ``open_arrival``: accept ``submit()`` while running and terminate by
        quiescence (DESIGN.md §Open-arrival) instead of the closed-workload
        fixed task count.  ``tasks`` may then be empty — it seeds the deques
        exactly like the closed static partition would.

        ``idle_backoff`` / ``idle_backoff_max``: an idle worker that failed
        to steal sleeps ``idle_backoff`` seconds, doubling per consecutive
        miss up to the cap (default 50× the base) — long-lived open-arrival
        pools must not spin at full speed between request waves.  A
        ``submit()`` wakes sleepers immediately.

        ``cost_class_fn`` / ``num_classes`` / ``ewma_alpha``: work-weighted
        stealing (DESIGN.md §Work-weighted stealing).  ``cost_class_fn(task)
        -> int`` tags every payload with a cost class in ``[0, num_classes)``
        (clamped; a raising classifier falls back to class 0 — never let
        accounting kill a worker).  Workers then track per-class EWMA
        runtimes (smoothing ``ewma_alpha``), publish per-class queue counts
        through the info ring, and ring policies price queues in estimated
        work-seconds.  Without a classifier the pool runs the count-based
        degenerate case — bit-for-bit the old behaviour.

        ``slowdown`` / ``limp``: the straggler plane (DESIGN.md §Straggler
        plane).  ``slowdown`` is a scripted :class:`SlowdownSchedule` of
        degraded-but-alive faults — each worker's task execution stalls by
        the scheduled multiplier (wall-clock, sleep-paced so the GIL stays
        fair), times measured from ``start()``; ``set_worker_slowdown``
        injects a live multiplier on top.  ``limp`` enables the owner-side
        limp DETECTOR (:class:`LimpConfig`): a flagged worker re-prices its
        published t so thieves strip its queue, stops initiating steals,
        and ``submit()`` stops routing new work to it.  ``limp=None`` keeps
        every policy bit-for-bit blind to stragglers.

        ``topology``: the network-cost model (DESIGN.md §Topology plane).
        When set, every policy view carries ``transfer_cost(j, ntasks)`` =
        seconds to move loot from j to this worker, so victim selection is
        distance-penalized, net-negative steals are refused, and a priced
        plan moves its loot as ONE batched transfer whose cost the thief
        pays in clock time (``StealPlan.delay``) before the loot lands.
        ``topology=None`` (default) is bit-for-bit the unpriced scheduler.

        ``netfaults``: the network-fault plane (DESIGN.md §Fault fabric).
        A :class:`NetFaultSchedule` of lossy links and timed partitions is
        injected into the steal transaction: a dropped/partitioned request
        leg is a failed attempt (timeout stall + per-link backoff when
        ``hardened``); a dropped transfer leg holds the loot in flight for
        ``lease_timeout`` and then RETURNS it to the victim (the threaded
        plane carries real payloads, so loot is never destroyed — the
        delivery-semantics table in DESIGN.md records this deliberate
        divergence from the simulator's un-hardened ablation).  Partitioned
        peers go heartbeat-stale in the OBSERVER's view only, ring gossip
        is gated per-link, and the first boundary after a heal resyncs the
        worker's send watermarks.  ``netfaults=None`` (default) is
        bit-for-bit the fault-free scheduler, including every rng stream.

        ``slo`` / ``slo_aging``: SLO-ordered owner pops (DESIGN.md §SLO
        serving).  When enabled, each worker pops its OWN deque through
        :func:`repro.core.deque.slo_key` — latency-class tasks jump
        batch-class tasks, earliest deadline first within class, and a
        batch task older than ``slo_aging`` seconds is promoted so a
        latency flood can never starve it.  SLO attributes come from the
        payloads themselves (:class:`repro.core.deque.Task` records or
        future-likes with ``slo_class``/``deadline``); plain payloads are
        batch-class, so ``slo=True`` over plain payloads degenerates to
        ordinary LIFO pops.  Thief-end steals are UNCHANGED — they strip
        the oldest tail slots, i.e. batch work preferentially.
        ``slo=False`` (default) takes the PR-9 head-pop path bit-for-bit.
        """
        self.num_workers = num_workers
        self.task_fn = task_fn
        self.policy = make_policy(policy, num_workers)
        self.seed = seed
        # The paper's 20% operating point tracks an ELASTIC pool: unless the
        # caller pinned a radius, membership changes recompute it.
        self._radius_explicit = radius is not None
        self.radius = radius if radius is not None else max(1, round(0.2 * num_workers))
        self.idle_backoff = idle_backoff
        self.idle_backoff_max = (
            idle_backoff_max if idle_backoff_max is not None else idle_backoff * 50
        )
        self.clock = clock
        self.open_arrival = open_arrival
        if num_classes < 1:
            raise ValueError("num_classes must be >= 1")
        self.cost_class_fn = cost_class_fn
        self.num_classes = num_classes if cost_class_fn is not None else 1
        self.ewma_alpha = ewma_alpha
        self.slowdown = slowdown
        self.limp_cfg = limp
        self.topology = topology
        self.netfaults = netfaults
        if not slo_aging > 0.0:  # also rejects NaN
            raise ValueError(f"slo_aging {slo_aging} must be > 0 (or inf)")
        self.slo = slo
        self.slo_aging = slo_aging
        # Shared per-(thief, victim) link-health tracker; single writer per
        # key (the thief thread), so plain dict mutation is GIL-safe.
        self._link_health = LinkHealth(netfaults) if netfaults is not None else None
        self._nf_lossy = netfaults is not None and netfaults.lossy()
        self._heal_times = netfaults.heal_times() if netfaults is not None else []
        # Fault-plane telemetry (written under _log_lock on the steal path).
        self._net_failed = 0
        self._lease_expired = 0
        self._fare_paid = 0.0
        # Owner-written limp flags (one bool per ring slot; plain list —
        # CPython element writes are atomic, readers tolerate staleness).
        self._limping: list[bool] = [False] * num_workers
        #: (time, worker, flagged) limp-detector transition telemetry
        self.limp_log: list[tuple[float, int, bool]] = []
        # Wedge detector (DESIGN.md §Straggler plane, LimpConfig.stale_after):
        # per-ring-slot heartbeat — the last time the worker's OWN loop
        # reached a boundary (`_update_info`), NaN until its first one.  A
        # worker stuck inside a task stops beating; an idle-but-healthy
        # worker keeps beating through its poll loop.  `_stale_flagged`
        # records whether the STALENESS path (not the owner EWMA) holds the
        # limp flag.  Plain lists, benign races: a lost update delays one
        # staleness verdict by one boundary.
        self._hb_beat: list[float] = [float("nan")] * num_workers
        self._stale_flagged: list[bool] = [False] * num_workers
        parts = self.policy.partition(tasks, num_workers)
        self.workers = [
            _WorkerState(
                TaskDeque(parts[w]), seed * 1009 + w, self.num_classes,
                limp_cfg=limp,
            )
            for w in range(num_workers)
        ]
        if netfaults is not None:
            for w in range(num_workers):
                self.workers[w].nf_rng = np.random.default_rng(
                    (seed * 1009 + w) ^ NF_SEED_SALT
                )
        # Hierarchy scoping (DESIGN.md §Hierarchy): a policy that carries a
        # CellMap gets one sub-board per cell and CELL-scoped views; the
        # substrate keeps speaking global ids throughout.
        self.cells = getattr(self.policy, "cells", None)
        if self.cells is not None and self.cells.num_workers != num_workers:
            raise ValueError(
                f"policy cell map covers {self.cells.num_workers} workers, "
                f"pool has {num_workers}"
            )
        # The §2.1 information board exists only for ring policies; central
        # or probe-based policies (LW, CTWS, random) pay no cell traffic.
        if not self.policy.uses_ring:
            self.info = None
        elif self.cells is not None:
            self.info = CellBoard(self.cells, self.num_classes)
            # Hand the board to the policy so leader-level member migration
            # can re-home sub-board columns (threaded plane only).
            self.policy.bind_board(self.info)
        else:
            self.info = RingInfo(num_workers, self.radius, self.num_classes)
        if topology is not None:
            # Per-boundary pricing flows through the view hook; the policy
            # hook exists for state that prices GLOBAL pairs outside a view
            # (the hierarchical leader balancer's cross-cell gate).
            self.policy.bind_topology(topology)
        self.done_counter = AtomicInt64(0)
        # Tasks ever made visible to the runtime (seed partition + submits).
        # Quiescence: submitted is bumped BEFORE the task is pushed, so
        # ``done >= submitted`` can only hold when no task is seeded, queued,
        # in flight, or mid-injection — see _finished.
        self.submitted = AtomicInt64(len(tasks))
        self.alive = AtomicInt64(num_workers)
        # Failure tombstones (the heartbeat/failure-detector channel of a
        # real deployment): a dead worker's info-vector cells go stale, so
        # thieves must stop trusting them — see _ring_view.
        self.dead = [False] * num_workers
        self.errors: list[tuple[int, object, BaseException]] = []
        self._steal_log: list[tuple[float, int, int, int]] = []
        self._failed_steals = 0
        self._records: list[TaskRecord] = []
        self._log_lock = threading.Lock()
        self._arrivals: dict[int, float] = {}  # id(task) -> submit time
        self._drained = threading.Event()
        if not open_arrival:
            self._drained.set()  # closed workload: nothing will ever arrive
        # Serialises the drained-check against drain() so a concurrent
        # submit can never slip a task past an exiting run loop.
        self._submit_lock = threading.Lock()
        # Serialises membership changes (add_worker/retire_worker) against
        # each other; readers stay lock-free — every membership structure
        # only ever APPENDS (workers, dead) or swaps whole boards (RingInfo
        # epoch guard), so a racing reader sees a valid old or new state.
        self._membership_lock = threading.Lock()
        #: (time, "join" | "retire" | "death", worker) membership telemetry
        self.membership_log: list[tuple[float, str, int]] = []
        self._rr = AtomicInt64(0)  # round-robin router for submit()
        self._threads: list[threading.Thread] = []
        # Per-SLOT thread handle (reuse gate: a tombstoned slot may only be
        # recycled once its old thread has fully exited — two threads must
        # never run the same worker loop).
        self._slot_threads: list[threading.Thread | None] = [None] * num_workers
        self._t0: float | None = None
        # Total-collapse hook: called exactly once, by the last dying
        # worker, with every task left stranded in the deques — so a caller
        # (ServePool) can fail the corresponding waiters instead of hanging.
        self.on_collapse: Callable[[list], None] | None = None

    # --------------------------------------------------------- open arrivals
    def submit(self, task, worker: int | None = None) -> int:
        """Thread-safe task injection while the run loop is live.

        Routes to ``worker`` when given, else to the policy's central queue
        (LW) when it declares one, else round-robins across live workers
        (the front-end sprays; adaptive stealing balances, §2.2).  Returns
        the worker the task landed on.  Valid in open-arrival mode only, any
        time before ``drain()``.  Raises :class:`PoolCollapsed` when no live
        worker exists — a task pushed onto a dead pool's deques would strand
        forever (detected again AFTER the push, in case the last worker dies
        mid-injection; the stranded sweep then routes to ``on_collapse``).
        """
        if not self.open_arrival:
            raise RuntimeError("submit() requires open_arrival=True")
        if self.alive.load() == 0:
            raise PoolCollapsed("submit() into a collapsed pool (no live workers)")
        if worker is None:
            central = self.policy.central
            if central is not None and self._routable(central):
                worker = central
            else:
                num = self.num_workers
                fallback = None
                for _ in range(num):
                    cand = self._rr.get_accumulate(1) % num
                    if self._routable(cand):
                        # Straggler response: keep fresh submits OFF a
                        # flagged-limping worker (its collapsed speed would
                        # bake straight into the task's latency) — unless
                        # every routable worker is limping, where serving
                        # slowly beats not serving at all.  Exception: the
                        # probation canaries — every Nth diverted task still
                        # lands on the flagged worker, the only completions
                        # that can ever clear its flag.
                        if not self._limping[cand]:
                            worker = cand
                            break
                        st = self.workers[cand].limp_state
                        if st is not None and st.should_probe():
                            worker = cand  # probation canary
                            break
                        if fallback is None:
                            fallback = cand
                else:
                    if fallback is not None:
                        worker = fallback
                    else:
                        # Every worker died/retired between the alive check
                        # and the scan — never settle on a dead deque.
                        raise PoolCollapsed(
                            "submit() into a collapsed pool (no live workers)"
                        )
        elif not 0 <= worker < self.num_workers:
            # Validate BEFORE touching the quiescence counter: a failed push
            # after the accumulate would leave `submitted` permanently ahead
            # of `done` and hang every later join().
            raise ValueError(f"worker {worker} out of range 0..{self.num_workers - 1}")
        now = self.clock()
        if type(task) is Task and task.arrival != task.arrival:
            # First-class records carry their own arrival (read by SLO aging
            # and telemetry); the stamp stack below still pairs completions.
            task.arrival = now
        with self._log_lock:
            # A stamp STACK per id: the same (or interned) payload object may
            # be submitted several times; pairing completions with the oldest
            # stamp keeps counts conserved and latencies non-negative.
            self._arrivals.setdefault(id(task), []).append(now)
        # Order matters for quiescence: count it, then make it stealable —
        # and the drained-check must be atomic with the count (a drain()
        # racing in between could let every worker exit while this task is
        # still on its way into a deque).
        with self._submit_lock:
            if self._drained.is_set():
                with self._log_lock:
                    stamps = self._arrivals.get(id(task))
                    if stamps:
                        stamps.pop()
                        if not stamps:
                            del self._arrivals[id(task)]
                raise RuntimeError("submit() after drain()")
            self.submitted.accumulate(1)
        self.workers[worker].deque.push([task])
        self._wake_all()
        if self.alive.load() == 0:
            # Total collapse raced the push: the last worker's dying sweep
            # may have missed this task — nobody will ever pop it.  Sweep
            # again (the hook fails the corresponding waiters), or — with no
            # hook — leave the queue in place for a possible resurrection
            # and surface the strand to the caller.
            if self._collapse_sweep() == 0 and self.on_collapse is None:
                raise PoolCollapsed(
                    "pool collapsed mid-submit; the task stays queued and "
                    "runs only if the pool is resurrected via add_worker() "
                    "— do not blindly resubmit"
                )
        return worker

    def _collapse_sweep(self) -> int:
        """Total collapse with a registered hook: pop every stranded task,
        hand the batch to ``on_collapse`` (which fails the waiters), and
        RECONCILE the quiescence counters — a swept task is permanently
        resolved, so it must count as done or ``pending()`` stays positive
        forever and a later resurrection (``add_worker``) could never reach
        quiescence.  Without a hook the queues are left intact (a
        resurrected pool serves them) and nothing is counted.  Returns the
        number of swept tasks."""
        if self.on_collapse is None:
            return 0
        stranded = self.drain_leftover_tasks()
        if stranded:
            self.done_counter.accumulate(len(stranded))
            self.on_collapse(stranded)
        return len(stranded)

    def _routable(self, worker: int) -> bool:
        """May ``submit()`` place new work on this worker's deque?"""
        return not self.dead[worker] and not self.workers[worker].retiring

    def _wake_all(self) -> None:
        """Wake every idle sleeper (submit/drain/membership/death events).
        Sets each worker's PRIVATE event — only its owner clears it, so a
        busy worker cycling through its loop cannot eat another's wakeup."""
        for w in self.workers:
            w.wake.set()

    def submit_many(self, tasks: Sequence, worker: int | None = None) -> list[int]:
        return [self.submit(t, worker) for t in tasks]

    def drain(self) -> None:
        """Announce end-of-workload: no further ``submit()`` is coming.  The
        run loop then exits as soon as quiescence is reached."""
        with self._submit_lock:
            self._drained.set()
        self._wake_all()

    def drain_leftover_tasks(self) -> list:
        """Pop every task still sitting in any deque.  Only meaningful once
        no worker will serve them again (after ``join()``, or from the
        collapse hook) — used to fail the waiters of stranded tasks."""
        leftover: list = []
        for w in self.workers:
            while True:
                task = w.deque.get_task()
                if task is None:
                    break
                leftover.append(task)
        return leftover

    def pending(self) -> int:
        """Tasks submitted but not yet executed (queued + in flight)."""
        return self.submitted.load() - self.done_counter.load()

    # ------------------------------------------------- elastic membership
    def add_worker(
        self, on_assign: Callable[[int], None] | None = None
    ) -> int:
        """Boot ONE new worker thread into the live pool (elastic scale-out,
        DESIGN.md §Elasticity) and return its id.

        Slot policy: the lowest tombstoned slot whose old thread has fully
        exited is REUSED (spot-preemption-with-replacement; an autoscaled
        pool cycling out/in keeps a bounded ring instead of growing O(P²)
        board state per surge) — the replacement inherits the tombstone's
        deque, so any still-orphaned tasks come back to life with it, and
        its info column resets to the unreported state.  Only when no such
        slot exists does the ring grow by one appended position.

        Either way the joiner immediately participates as a thief, so
        existing work flows to it through the ordinary steal protocol — no
        re-partitioning — and every other member prices it by the §2.2.1
        preemptive wall-time estimate (NaN cells) exactly like an
        unreported boot member.  Joining a COLLAPSED pool resurrects it —
        but note any ``on_collapse`` sweep that already fired kept its word
        to the old waiters.

        ``on_assign(wid)`` runs under the membership lock after the id is
        fixed but BEFORE the worker thread starts — callers that index
        side tables by worker id (``ServePool.replicas``) install the entry
        there, never racing the first ``task_fn`` call.

        Telemetry note: a recycled slot's per-worker counters
        (``per_worker_tasks``/``per_worker_mean_t``) restart with the
        replacement; ``RunStats.records`` keeps every incarnation's tasks.
        """
        with self._membership_lock:
            if self._t0 is None:
                raise RuntimeError("add_worker() requires a started pool")
            wid = next(
                (
                    k for k in range(len(self.workers))
                    if self.dead[k]
                    and self._slot_threads[k] is not None
                    and not self._slot_threads[k].is_alive()
                ),
                len(self.workers),
            )
            now = self.clock()
            if wid < len(self.workers):
                # Replacement: fresh run state, inherited deque (orphans on
                # the tombstone become the joiner's backlog).
                w = _WorkerState(
                    self.workers[wid].deque, self.seed * 1009 + wid,
                    self.num_classes, limp_cfg=self.limp_cfg,
                )
                w.start_time = now
                self.workers[wid] = w
                if self.netfaults is not None:
                    w.nf_rng = np.random.default_rng(
                        (self.seed * 1009 + wid) ^ NF_SEED_SALT
                    )
                self._limping[wid] = False  # the ghost's flag dies with it
                self._hb_beat[wid] = float("nan")  # heartbeat restarts too
                self._stale_flagged[wid] = False
                if self.info is not None:
                    self.info.reset_member(wid)  # back to the unreported state
                self.dead[wid] = False
            else:
                w = _WorkerState(
                    TaskDeque([]), self.seed * 1009 + wid, self.num_classes,
                    limp_cfg=self.limp_cfg,
                )
                w.start_time = now  # preemptive-estimate baseline = NOW
                if self.netfaults is not None:
                    w.nf_rng = np.random.default_rng(
                        (self.seed * 1009 + wid) ^ NF_SEED_SALT
                    )
                # Append order matters for lock-free readers: the worker and
                # its tombstone slot exist BEFORE any count admits id wid.
                self.workers.append(w)
                self.dead.append(False)
                self._limping.append(False)
                self._hb_beat.append(float("nan"))
                self._stale_flagged.append(False)
                self._slot_threads.append(None)
                self.num_workers = len(self.workers)
                if not self._radius_explicit:
                    self.radius = max(1, round(0.2 * self.num_workers))
                if self.info is not None and self.cells is None:
                    self.info.grow(self.num_workers, self.radius)
            # (No own-cell publish here: the joiner's loop does it as its
            # first action — §2.2.1 elapsed-time self-report, as at boot —
            # and until then every thief prices the NaN cell preemptively.)
            if self.netfaults is not None:
                # A joiner is born past any already-healed partitions: start
                # its heal cursor beyond them so it never replays a resync.
                tj = now - self._t0 if self._t0 is not None else 0.0
                w.heal_idx = sum(1 for h in self._heal_times if h <= tj)
            self.alive.accumulate(1)
            self.policy.on_worker_join(wid, now)
            if self.info is not None and self.cells is not None:
                # Hierarchy ordering: the join hook HOMED the joiner (CellMap
                # assign), so only now can its cell's sub-board grow to cover
                # the new local slot.  Readers that race the gap clamp their
                # member list to the board rows they copied (_ring_view).
                self.info.ensure(wid)
            with self._log_lock:
                self.membership_log.append((now, "join", wid))
            if on_assign is not None:
                on_assign(wid)
            th = threading.Thread(
                target=self._worker_loop, args=(wid,), daemon=True
            )
            self._slot_threads[wid] = th
            self._threads.append(th)
            th.start()
        self._wake_all()  # sleepers re-derive windows over the new ring
        return wid

    def retire_worker(self, worker: int, drain: bool = True) -> None:
        """Gracefully remove ``worker`` from the live pool (scale-in /
        maintenance drain).  Asynchronous: the worker finishes its in-flight
        task, then — with ``drain=True`` — re-distributes its queued tasks
        over the surviving workers before tombstoning itself and exiting;
        ``drain=False`` tombstones immediately and leaves the queue on the
        (still readable) dead deque for thieves to reclaim, i.e. the fault
        path minus the crash.  Idempotent; retiring the last live worker
        collapses the pool (the ``on_collapse`` sweep runs as on death).
        """
        with self._membership_lock:
            if not 0 <= worker < self.num_workers:
                raise ValueError(
                    f"worker {worker} out of range 0..{self.num_workers - 1}"
                )
            w = self.workers[worker]
            if self.dead[worker] or w.retiring:
                return
            w.drain_on_retire = drain
            w.retiring = True
        self._wake_all()  # a sleeping retiree must wake to process the flag

    def _retire(self, i: int, w: _WorkerState) -> None:
        """Executed ON the retiring worker's thread at a task boundary — it
        never interrupts a task mid-flight."""
        self.dead[i] = True  # tombstone first: submit() stops routing here
        if w.drain_on_retire:
            targets = [
                j for j in range(self.num_workers)
                if j != i and not self.dead[j] and not self.workers[j].retiring
            ]
            leftover = []
            while True:
                task = w.deque.get_task()
                if task is None:
                    break
                leftover.append(task)
            if targets:
                for k, task in enumerate(leftover):
                    self.workers[targets[k % len(targets)]].deque.push([task])
            else:
                # Nobody left to hand them to; keep them visible on the dead
                # deque so the collapse sweep below can fail their waiters.
                w.deque.push(leftover)
        if self.info is not None:
            self._update_info(i)
            self._communicate(i)
        now = self.clock()
        self.policy.on_worker_death(i, now)
        with self._log_lock:
            self.membership_log.append((now, "retire", i))
        self.alive.accumulate(-1)
        self._wake_all()
        if self.alive.load() == 0:
            self._collapse_sweep()

    def _communicate(self, i: int) -> None:
        """Ring gossip for worker ``i``, gated by the fault plane.

        Partitions stop information flow: a cell cannot cross an active cut,
        so each neighbour push is filtered by reachability (``can_send``).
        The first boundary after a partition HEALS resyncs ``i``'s send
        watermarks (``RingInfo.resync``) — neighbours whose copies froze at
        the cut receive the full window again instead of nothing (the
        watermark says "already sent") — and clears ``i``'s steal backoffs,
        since the post-heal link is presumed healthy until re-observed.
        Plain message drops deliberately do NOT apply to gossip: the §2.1
        ring is modelled as eventually-consistent background traffic, and
        DESIGN.md §Fault fabric records the simplification.  With
        ``netfaults=None`` this is exactly ``info.communicate(i)``.
        """
        if self.info is None:
            return
        nf = self.netfaults
        if nf is None or self._t0 is None:
            self.info.communicate(i)
            return
        tnow = self.clock() - self._t0
        w = self.workers[i]
        if w.heal_idx < len(self._heal_times) and tnow >= self._heal_times[w.heal_idx]:
            while (
                w.heal_idx < len(self._heal_times)
                and tnow >= self._heal_times[w.heal_idx]
            ):
                w.heal_idx += 1
            self.info.resync(i)
            self._link_health.clear_backoff(i)
        if nf.partitions:
            self.info.communicate(
                i, can_send=lambda j, _i=i, _t=tnow: nf.reachable(_i, j, _t)
            )
        else:
            self.info.communicate(i)

    def _finished(self) -> bool:
        """Quiescence termination (DESIGN.md §Open-arrival).

        ``done == submitted`` means every task ever injected has finished
        executing; tasks never vanish (steals move them, worker failure
        re-queues them), so all deques are provably empty at that point.
        An empty deque alone proves nothing — the task may be in another
        worker's deque, in a thief's hands mid-transfer, or not arrived yet —
        hence the additional ``drain()`` gate before the loop may exit.
        """
        return self._drained.is_set() and (
            self.done_counter.load() >= self.submitted.load()
        )

    # ------------------------------------------------------------- Algorithm 1
    def start(self) -> None:
        """Boot the worker threads and return immediately (open-arrival
        servers feed ``submit()`` from here on; closed runs just ``join``)."""
        if self._threads:
            raise RuntimeError("runtime already started")
        t0 = self.clock()
        self._t0 = t0
        for w in self.workers:
            w.start_time = t0
        if self.info is not None:
            for i in range(self.num_workers):
                self._update_info(i)
        self.policy.on_start([len(w.deque) for w in self.workers], t0)
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i,), daemon=True)
            for i in range(self.num_workers)
        ]
        self._slot_threads = list(self._threads)
        for th in self._threads:
            th.start()

    def join(self) -> RunStats:
        """Wait for termination and return the final stats.  Open-arrival
        callers must ``drain()`` first or the workers wait forever for more
        work (by design — that is what keeps the pool alive between waves)."""
        k = 0
        while k < len(self._threads):  # add_worker may append mid-join
            self._threads[k].join()
            k += 1
        self.policy.termination(self.clock())
        return self.stats_snapshot()

    def run(self) -> RunStats:
        self.start()
        return self.join()

    def stats_snapshot(self) -> RunStats:
        """Consistent stats up to now — callable while the pool is live."""
        t1 = self.clock()
        per_tasks = [w.executed for w in self.workers]
        per_t = [
            (w.runtime_sum / w.executed) if w.executed else float("nan")
            for w in self.workers
        ]
        with self._log_lock:
            records = sorted(self._records, key=lambda r: r.start)
            steals = list(self._steal_log)
            failed = self._failed_steals
        return RunStats(
            makespan=t1 - (self._t0 if self._t0 is not None else t1),
            records=records,
            steals=steals,
            failed_steals=failed,
            info_cells_sent=self.info.puts if self.info is not None else 0,
            corrections=sum(w.deque.corrections for w in self.workers),
            per_worker_tasks=per_tasks,
            per_worker_mean_t=per_t,
            net_failed=self._net_failed,
            lease_expired=self._lease_expired,
            fare_paid=self._fare_paid,
        )

    def _worker_loop(self, i: int) -> None:
        w = self.workers[i]
        idle_misses = 0
        while not self._finished():
            if w.retiring:  # graceful leave, only ever at a task boundary
                self._retire(i, w)
                return
            if self.info is not None:
                self._update_info(i)  # line 2
            self._policy_boundary(i)  # lines 3-9 (policy gates preemption)
            w.wake.clear()  # own event only, before the deque check: a
            # concurrent submit() re-sets it and the wait below falls through
            task = w.deque.get_task(  # line 10
                slo_key(self.clock(), self.slo_aging) if self.slo else None
            )
            if task is None:
                # Empty deque: keep thieving until quiescence.
                if self.alive.load() == 0:
                    return  # every worker died; nothing left to wait for
                if self.info is not None:
                    self._communicate(i)
                if not self._policy_boundary(i):
                    idle_misses += 1
                    w.wake.wait(
                        min(
                            self.idle_backoff * (2.0 ** min(idle_misses, 30)),
                            self.idle_backoff_max,
                        )
                    )
                continue
            idle_misses = 0
            if self.info is not None:
                self._update_info(i)  # line 11
            start = self.clock()
            try:
                self.task_fn(i, task)  # line 12
            except BaseException as e:  # noqa: BLE001 — fault tolerance
                # Worker failure: return the task to the deque so survivors
                # can steal it, raise the tombstone, publish, and die.
                w.deque.push([task])
                with self._log_lock:
                    self.errors.append((i, task, e))
                self.dead[i] = True
                if self.info is not None:
                    self._update_info(i)
                    self._communicate(i)
                now = self.clock()
                self.policy.on_worker_death(i, now)
                with self._log_lock:
                    self.membership_log.append((now, "death", i))
                self.alive.accumulate(-1)
                self._wake_all()  # idle sleepers must re-check alive state
                if self.alive.load() == 0:
                    # Last worker standing just died: nobody will ever pop
                    # the remaining tasks — hand them to the caller so the
                    # corresponding waiters fail instead of hanging.
                    self._collapse_sweep()
                return
            mult = self.policy.task_multiplier(i)
            if mult > 1.0:
                _busy_wait((self.clock() - start) * (mult - 1.0), self.clock)
            slow = self._slow_factor(i, w, start)
            if slow > 1.0:
                # Degraded-but-alive fault injection: stretch the task's
                # wall time by the scripted/injected multiplier.  Sleep-
                # paced (not a busy wait) — a throttled or IO-stalled node
                # yields its cycles, and on a CI box a spinning straggler
                # would starve the very threads that should out-run it.
                _sleep_stall((self.clock() - start) * (slow - 1.0), self.clock)
            end = self.clock()
            w.executed += 1
            w.runtime_sum += end - start
            w.ran_any = True
            if self.weighted:
                self._observe_class_time(w, task, end - start)
            if w.limp_state is not None:
                self._observe_limp(i, w, task, end - start)
            with self._log_lock:
                stamps = self._arrivals.get(id(task))
                arrival = stamps.pop(0) if stamps else float("nan")
                if stamps is not None and not stamps:
                    del self._arrivals[id(task)]
                self._records.append(TaskRecord(task, i, start, end, arrival))
            self.done_counter.accumulate(1)
            if self._finished():
                self._wake_all()  # completion wakes idle sleepers to exit
            if self.info is not None:
                self._update_info(i)
                self._communicate(i)  # line 13

    # ------------------------------------------------------- straggler plane
    def set_worker_slowdown(self, worker: int, factor: float) -> None:
        """Live fault injection: multiply ``worker``'s task execution time
        by ``factor`` from its next task on (1.0 restores native speed).
        Composes multiplicatively with any scripted ``slowdown`` schedule.
        Thread-safe: a single float store, read once per task boundary."""
        if not 0 <= worker < self.num_workers:
            raise ValueError(
                f"worker {worker} out of range 0..{self.num_workers - 1}"
            )
        if not math.isfinite(factor) or factor <= 0.0:
            raise ValueError(f"slowdown factor {factor} must be finite > 0")
        self.workers[worker].slow_mult = float(factor)

    def limping(self, worker: int) -> bool:
        """Current limp verdict for ``worker`` — owner-side EWMA or the
        peer-side staleness flag (False when detection is disabled)."""
        return self._limping[worker]

    def _slow_factor(self, i: int, w: _WorkerState, now: float) -> float:
        """Combined slowdown multiplier for a task that started at ``now``
        (clock units): manual injection x the scripted schedule, evaluated
        at task start — mirroring the simulator's ``start_task``."""
        f = w.slow_mult
        if self.slowdown is not None and self._t0 is not None:
            f *= self.slowdown.factor_at(i, now - self._t0)
        return f

    def _observe_limp(self, i: int, w: _WorkerState, task, dt: float) -> None:
        """Owner-side limp detection on a completed task (the only signal
        the owner can actually observe — DESIGN.md §Straggler plane caveat:
        a fully wedged worker never reaches this line)."""
        st = w.limp_state
        cls = self._task_class(task) if self.weighted else 0
        st.observe(
            normalize_duration(dt, cls, w.class_t if self.weighted else None)
        )
        peer = float("nan")
        if st.samples < st.cfg.min_samples and self.info is not None:
            # Boot-limped fallback: the own baseline is not trusted yet, so
            # reference the median published t of the live window peers
            # (cell-scoped under a hierarchy board — a limper is judged
            # against ITS cell, not the whole pool).
            vals = [
                t
                for j, t in self.info.peer_raw_t(i)
                if not self.dead[j] and t == t
            ]
            if vals:
                peer = float(np.median(vals))
        flagged = st.evaluate(peer)
        if flagged != self._limping[i]:
            self._limping[i] = flagged
            with self._log_lock:
                self.limp_log.append((self.clock(), i, flagged))

    # ----------------------------------------------------------------- helpers
    @property
    def weighted(self) -> bool:
        """Work-weighted accounting active.  Requires a classifier AND at
        least two classes: a single class carries no composition information
        and its per-class EWMA would differ from the arithmetic-mean t the
        count plan prices with — the degenerate case must stay bit-for-bit
        count-based (tests/test_weighted.py)."""
        return self.cost_class_fn is not None and self.num_classes > 1

    def _task_class(self, task) -> int:
        """Clamped cost class of a payload: :class:`Task` records answer
        from their ``cls`` field directly; bare payloads go through the
        classifier, where a raising classifier maps to class 0 —
        accounting must never take a worker down."""
        if type(task) is Task:
            return min(max(task.cls, 0), self.num_classes - 1)
        try:
            c = int(self.cost_class_fn(task))  # type: ignore[misc]
        except Exception:  # noqa: BLE001 — user classifier, defensive
            return 0
        return min(max(c, 0), self.num_classes - 1)

    def _class_counts(self, tasks) -> np.ndarray:
        # Shared loot/queue accounting (steal.class_counts) — one Task-aware
        # histogram for both planes.
        return np.asarray(
            class_counts(tasks, self.cost_class_fn, self.num_classes),
            dtype=np.float64,
        )

    def _queue_classes(self, w: _WorkerState) -> np.ndarray:
        """Cached composition scan of a worker's own deque: re-scans only
        when the deque's mutation hint moved.  The returned array is never
        mutated in place (always replaced), so sharing it with the info
        board is safe."""
        key = (w.deque.mutations, w.deque.headtail.load())
        cached = w.nc_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        counts = self._class_counts(w.deque.snapshot_tasks())
        w.nc_cache = (key, counts)
        return counts

    def _observe_class_time(self, w: _WorkerState, task, dt: float) -> None:
        """Owner-side EWMA update t̂[c] ← α·dt + (1−α)·t̂[c] on completion."""
        c = self._task_class(task)
        prev = w.class_t[c]
        if prev != prev:  # first observation of this class
            w.class_t[c] = dt
        else:
            a = self.ewma_alpha
            w.class_t[c] = a * dt + (1.0 - a) * prev

    def _update_info(self, i: int) -> None:
        """Closed: n_i = executed + queued (paper §2.2).  Open-arrival:
        n_i = instantaneous queue depth — cumulative totals are meaningless
        as a balance target while tasks keep arriving (DESIGN.md
        §Open-arrival).  Either way t_i = mean runtime, or elapsed wall time
        before the first task finishes (preemptive stealing, §2.2.1)."""
        # Heartbeat for the wedge detector: the owner's loop reached a
        # boundary RIGHT NOW — a worker stuck inside a task never gets here.
        self._hb_beat[i] = self.clock()
        w = self.workers[i]
        if self.open_arrival:
            n_i = len(w.deque)
        else:
            n_i = w.executed + len(w.deque)
        if w.executed > 0:
            t_i = w.runtime_sum / w.executed
        else:
            t_i = max(self.clock() - w.start_time, 1e-9)
        limping = self._limping[i]
        if limping:
            # Adaptive RE-PRICING (DESIGN.md §Straggler plane): a flagged
            # limper publishes its collapsed fast-EWMA instead of the slow-
            # moving cumulative mean, so the existing fair-share mathematics
            # (Eq. 5) immediately marks it massively surplus and thieves
            # strip its queue through the ordinary steal path.
            recent = w.limp_state.recent
            if recent == recent:
                t_i = max(t_i, recent)
        if self.weighted:
            # Per-class payload: own queue composition (ground-truth scan of
            # the own deque) + per-class EWMA estimates, same cell version.
            self.info.update_local(
                i, float(n_i), float(t_i),
                nc_i=self._queue_classes(w),
                tc_i=w.class_t.copy(),
                limp_i=limping,
            )
        else:
            self.info.update_local(i, float(n_i), float(t_i), limp_i=limping)

    def _ring_view(self, i: int) -> tuple:
        """A2WS information model: what thief ``i`` may believe (§2.1/§2.2.1).

        Estimates use ONLY the thief's information vector (plus the elapsed
        wall time for preemptive estimates, §2.2.1) — never ground-truth
        reads of remote state.  Over/under-estimates are absorbed by the
        Fig. 3b atomic adjust-and-correct protocol, exactly as in the paper.

        Returns ``(n, t, queued, window, unit, qtasks, rel, ntasks, limp,
        members, nc, iview, rad)``; ``unit``/``qtasks``/``rel``/``ntasks``
        are the work-weighted overlay (None in count mode).  In weighted mode
        ``n``/``queued`` are measured in equivalent reference-class tasks
        (DESIGN.md §Work-weighted stealing) while ``qtasks`` keeps the task
        counts for integrality guards and the Fig. 3b clamp.  ``limp`` is the
        delayed limp-flag row (None when detection is off).

        Hierarchy scoping (DESIGN.md §Hierarchy): under a cell-mapped policy
        every returned array speaks LOCAL cell slots and ``members`` carries
        the local→global mapping (``-1`` = migration hole); flat boards
        return ``members=None`` with ``iview=i`` and the pool radius — the
        same loop runs either way, just over a different index set.
        """
        w = self.workers[i]
        # One board epoch for rows + window: a concurrent grow() can never
        # produce a window index outside the copied rows.
        n_view, t_view, raw_t, window, nc_view, tc_view, limp_row = (
            self.info.view_window_all(i)
        )
        m = len(n_view)
        if self.cells is not None:
            cell, iview = self.cells.locate(i)
            mem = self.cells.members(cell)
            # Clamp to the board rows copied above: a concurrent join may
            # have appended a member slot the sub-board has not grown to
            # cover yet (add_worker homes, then grows).
            if len(mem) < m:
                mem = mem + [-1] * (m - len(mem))
            members = np.asarray(mem[:m], dtype=np.int64)
            rad = self.cells.radius_of(cell)
        else:
            members = None
            iview = i
            rad = self.radius
        if self.limp_cfg is not None:
            limp_row[iview] = self._limping[i]  # own flag: ground truth, no lag
        else:
            limp_row = None
        wedge = self.limp_cfg is not None and math.isfinite(
            self.limp_cfg.stale_after
        )
        now = self.clock()
        elapsed = max(now - w.start_time, 1e-9)
        queued = np.zeros(m)
        for jl in window:
            g = jl if members is None else int(members[jl])
            if g < 0:
                # Migration hole: no member behind this slot any more —
                # empty, priced at speed ~0 so Eq. 5 never assigns it work.
                queued[jl] = 0.0
                t_view[jl] = 1e12
                n_view[jl] = 0.0
                continue
            if jl == iview:
                queued[jl] = len(w.deque)
                if self.open_arrival:
                    n_view[jl] = queued[jl]
                continue
            if self.dead[g]:
                # Tombstoned worker: its info cells are frozen garbage.  Its
                # RMA window (deque) is still readable — count the orphaned
                # tasks directly and report speed ~0 so the fair share never
                # assigns it anything.
                queued[jl] = len(self.workers[g].deque)
                t_view[jl] = 1e12
                n_view[jl] = (
                    queued[jl]
                    if self.open_arrival
                    else self.workers[g].executed + queued[jl]
                )
                continue
            if np.isnan(raw_t[jl]):
                # No report from j yet: preemptive wall-time estimate — j
                # looks like it has finished 0 tasks in `elapsed` seconds.
                t_view[jl] = elapsed
            if wedge:
                # Wedge detector (LimpConfig.stale_after): j's heartbeat is
                # the last boundary its OWN loop reached (`_update_info`) —
                # an idle worker keeps beating through its poll loop, so
                # only a worker stuck INSIDE a task goes silent.  Silence
                # past stale_after means j is wedged (slowdown → ∞): the
                # owner-side EWMA can never flag it because it only observes
                # COMPLETED tasks, so the PEER raises the limp flag —
                # routing skips it, and the §2.2.1-style re-pricing below
                # marks its whole queue surplus so thieves strip it.
                hb = self._hb_beat[g]
                if hb == hb and now - hb > self.limp_cfg.stale_after:
                    if not self._stale_flagged[g]:
                        self._stale_flagged[g] = True
                        if not self._limping[g]:
                            self._limping[g] = True
                            with self._log_lock:
                                self.limp_log.append((now, g, True))
                    # Progressive re-pricing: j has produced nothing for the
                    # whole stale window, so its believed speed can be no
                    # better than one task per silence — closed-mode
                    # done_est → 0 and thieves see the full queue.
                    t_view[jl] = max(t_view[jl], now - hb)
                    limp_row[jl] = True
                elif self._stale_flagged[g]:
                    # Heartbeat is back: hand the verdict back to the
                    # owner-side EWMA hysteresis.
                    self._stale_flagged[g] = False
                    st = self.workers[g].limp_state
                    verdict = bool(st.limping) if st is not None else False
                    if self._limping[g] != verdict:
                        self._limping[g] = verdict
                        with self._log_lock:
                            self.limp_log.append((now, g, verdict))
            if self.netfaults is not None and self._t0 is not None:
                # Partition staleness (DESIGN.md §Fault fabric): when a cut
                # separates i from g, g's heartbeat FREEZES from i's vantage
                # at the cut instant (no message crosses), so after
                # nf.stale_after of frozen silence i prices g as stale —
                # exactly the wedge detector's re-pricing, but OBSERVER-
                # LOCAL: no global _limping/_stale_flagged writes, because
                # g's own side of the cut still sees it healthy.  Heals undo
                # this automatically: unreachable_since returns inf again
                # and the real (still-beating) heartbeat shows through.
                cut = self.netfaults.unreachable_since(g, i, now - self._t0)
                if cut < math.inf:
                    hb_eff = effective_heartbeat(
                        self._hb_beat[g], self._t0 + cut
                    )
                    if hb_eff == hb_eff and (
                        now - hb_eff > self.netfaults.stale_after
                    ):
                        t_view[jl] = max(t_view[jl], now - hb_eff)
                        if limp_row is not None:
                            limp_row[jl] = True
            if self.open_arrival:
                # n_j IS the reported depth; no elapsed-time extrapolation —
                # depth both drains (execution) and refills (arrivals), so
                # decaying it would systematically under-count busy victims.
                queued[jl] = max(n_view[jl], 0.0)
            else:
                # Estimated executed count from speed; remaining = n_j - done.
                done_est = min(elapsed / max(t_view[jl], 1e-9), n_view[jl])
                queued[jl] = max(n_view[jl] - done_est, 0.0)
        if not self.weighted:
            return (
                n_view, t_view, queued, window, None, None, None, None,
                limp_row, members, None, iview, rad,
            )
        # ---- work-weighted overlay (DESIGN.md §Work-weighted stealing) ----
        # Ground-truth compositions where the thief may read them: its own
        # deque, and tombstoned deques (already ground-truth counted above).
        nc_view[iview] = self._queue_classes(w)
        tc_view[iview] = w.class_t
        for jl in window:
            g = jl if members is None else int(members[jl])
            if jl != iview and g >= 0 and self.dead[g]:
                nc_view[jl] = self._queue_classes(self.workers[g])
        # Shared re-pricing (steal.weighted_overlay — ONE implementation for
        # both planes): tombstones (and migration holes) are frozen at their
        # ~0-speed price.
        if members is None:
            frozen = np.fromiter(
                (self.dead[j] for j in range(m)), dtype=bool, count=m,
            )
        else:
            frozen = np.fromiter(
                (members[jl] < 0 or self.dead[members[jl]] for jl in range(m)),
                dtype=bool, count=m,
            )
        # Preallocated per-worker scratch: the overlay's temporaries dominate
        # the per-boundary hot path at scale, and a boundary fully consumes
        # its view before the next one starts, so reuse is safe.
        buf = OverlayBuffers.ensure(w.overlay_buf, m, self.num_classes)
        w.overlay_buf = buf
        n_w, t_w, queued_w, unit, qtasks, rel = weighted_overlay(
            n_view, t_view, queued, nc_view, tc_view, frozen=frozen, buf=buf
        )
        # n_view stays the COUNT estimate (n_w is a fresh array): the Fig. 3b
        # reconciliation writes the board's count-denominated n from it.
        return (
            n_w, t_w, queued_w, window, unit, qtasks, rel, n_view,
            limp_row, members, nc_view, iview, rad,
        )

    def _make_view(self, i: int) -> PolicyView:
        w = self.workers[i]
        unit = qtasks = rel = ntasks = limp_row = members = nc_view = None
        iview, rad = i, self.radius
        if self.info is not None:
            (
                n_view, t_view, queued, window, unit, qtasks, rel, ntasks,
                limp_row, members, nc_view, iview, rad,
            ) = self._ring_view(i)
            num_workers = len(n_view)  # the board epoch's ring size
        else:
            n_view = t_view = queued = None
            num_workers = self.num_workers
            window = list(range(num_workers))
        if members is None:
            depth = lambda j: len(self.workers[j].deque)  # noqa: E731
            alive = lambda j: not self.dead[j]  # noqa: E731
        else:
            # Scoped view: the policy speaks LOCAL slot indices; translate
            # through the member map (holes read as empty tombstones).
            mem = members
            depth = lambda jl: (  # noqa: E731
                len(self.workers[mem[jl]].deque) if mem[jl] >= 0 else 0
            )
            alive = lambda jl: (  # noqa: E731
                mem[jl] >= 0 and not self.dead[mem[jl]]
            )
        tcost = None
        if self.topology is not None:
            topo = self.topology
            if members is None:
                # transfer_cost(j, k) = seconds to move k tasks FROM j TO i.
                tcost = lambda j, k, _t=topo, _i=i: _t.cost(  # noqa: E731
                    int(j), _i, int(k)
                )
            else:
                # Scoped view: j is a LOCAL slot — translate through the
                # member map; a migration hole is unreachable (inf).
                def tcost(jl, k, _t=topo, _i=i, _mem=members):
                    g = int(_mem[jl]) if 0 <= jl < len(_mem) else -1
                    if g < 0:
                        return float("inf")
                    return _t.cost(g, _i, int(k))
        lh = None
        if self.netfaults is not None and self._t0 is not None:
            # link_health(j) in [0, 1]: 0 across an active partition or a
            # backed-off link, else the link's success EWMA (floor-clamped,
            # 1.0 until first observed) — victim weights multiply by it.
            nf, hlt, t0, clk = (
                self.netfaults, self._link_health, self._t0, self.clock,
            )
            if members is None:
                def lh(j, _i=i, _nf=nf, _h=hlt, _t0=t0, _c=clk):
                    tnow = _c() - _t0
                    g = int(j)
                    if not _nf.reachable(g, _i, tnow):
                        return 0.0
                    return _h.factor(_i, g, tnow)
            else:
                def lh(jl, _i=i, _nf=nf, _h=hlt, _t0=t0, _c=clk, _mem=members):
                    g = int(_mem[jl]) if 0 <= jl < len(_mem) else -1
                    if g < 0:
                        return 0.0
                    tnow = _c() - _t0
                    if not _nf.reachable(g, _i, tnow):
                        return 0.0
                    return _h.factor(_i, g, tnow)
        return PolicyView(
            worker=iview,
            now=self.clock(),
            idle=len(w.deque) == 0,
            ran_any=w.ran_any,
            open_arrival=self.open_arrival,
            radius=rad,
            num_workers=num_workers,
            rng=w.rng,
            window=window,
            depth=depth,
            alive=alive,
            pending=self.pending,
            n_view=n_view,
            t_view=t_view,
            queued=queued,
            unit=unit,
            qtasks=qtasks,
            rel=rel,
            ntasks=ntasks,
            limp=limp_row,
            members=members,
            nc_view=nc_view,
            transfer_cost=tcost,
            link_health=lh,
        )

    def _policy_boundary(self, i: int) -> bool:
        """Consult the policy at a task boundary; execute any steal it plans
        (Alg. 1 lines 4-8 for A2WS: steal_equation -> select_victim ->
        steal_task via the Fig. 3b protocol)."""
        view = self._make_view(i)
        plan = self.policy.on_boundary(view)
        if plan is None:
            return False
        # Plans name GLOBAL victims (hierarchy policies translate before
        # returning).  Under a scoped view, resolve the local row for the
        # reconciliation below; an inter-cell victim has none — its board
        # lives in another cell, so the steal executes but no cell is
        # reconciled (CellBoard drops cross-cell record_remote anyway).
        vloc = plan.victim
        xcell = False
        if view.members is not None:
            hits = np.nonzero(view.members == plan.victim)[0]
            if hits.size:
                vloc = int(hits[0])
            else:
                xcell = True
        nf = self.netfaults
        if nf is not None and self._t0 is not None:
            # ---- request leg (DESIGN.md §Fault fabric) ----
            # Deterministic reachability first (consumes no randomness), then
            # the drop roll on the DEDICATED nf rng — the scheduling stream
            # stays untouched.  A lost request teaches the thief nothing
            # about the victim (no snapshot, no reconciliation): it times
            # out, records the link failure, and backs off.
            tnow = self.clock() - self._t0
            req_lost = not nf.reachable(i, plan.victim, tnow)
            if not req_lost:
                pd = nf.drop_prob(i, plan.victim, tnow)
                if pd > 0.0 and float(self.workers[i].nf_rng.random()) < pd:
                    req_lost = True
            if req_lost:
                self._failed_steals += 1
                with self._log_lock:
                    self._net_failed += 1
                if nf.hardened:
                    self._link_health.record(i, plan.victim, False, tnow)
                    _sleep_stall(nf.attempt_timeout, self.clock)
                self.policy.on_steal_result(view, plan, 0, 0)
                return False
        if plan.delay > 0.0 and self.topology is None:
            # Policy-priced dispatch latency (LW's leader round-trip),
            # charged in CLOCK units: the policy booked its gate against
            # view.now from self.clock, so a scaled/virtual clock must see
            # the same delay it priced — a raw time.sleep would not.
            # (With a topology, plan.delay is the TRANSPORT fare instead,
            # and it is paid after the claim — loot in flight overlaps the
            # victim's compute; see the transport leg below.)
            deadline = self.clock() + plan.delay
            while True:
                remaining = deadline - self.clock()
                if remaining <= 0.0:
                    break
                time.sleep(min(remaining, 1e-3))
        victim = self.workers[plan.victim]
        if (
            self.weighted and plan.work > 0.0 and view.rel is not None
            and plan.delay <= 0.0
        ):
            # Work-greedy loot (DESIGN.md §Work-weighted stealing): claim
            # tail slots until the plan's work target is covered, pricing
            # each candidate by its class — the count `amount` is only the
            # mean-unit estimate and over/under-shoots under tail skew.
            # A PRICED plan (delay > 0, §Topology plane) is excluded: its
            # loot must move as ONE batched transfer — the per-task greedy
            # loop would be k separately-priced hops the plan never paid
            # for, so it takes the single batched claim below instead.
            rel = view.rel
            result = victim.deque.steal_by_work(
                plan.work,
                lambda task: float(rel[self._task_class(task)]),
                max_tasks=max(plan.amount, int(math.ceil(2.0 * plan.work))),
                take_first=view.idle,  # idle thieves stay work-conserving
            )
        else:
            result = victim.deque.steal(plan.amount)  # Fig. 3b protocol
        # The get-accumulate snapshot tells the thief the victim's exact
        # remaining queue; fold it into the information vector (Table 1).
        observed_left = max(result.observed_tail - result.observed_head, 0)
        got = len(result.tasks)
        left = max(observed_left - got, 0)
        # Closed-mode reconciliation: n_j is the victim's TOTAL (executed +
        # queued, §2.2).  The snapshot gives ground truth for the QUEUED
        # part only, so keep the executed estimate the thief already priced
        # (n_view − queued estimate) and replace the queued estimate with
        # the observation: corrected n = done_est + observed queue.
        # (Subtracting the remaining queue from the total — the old rule —
        # left a drained victim at its stale full n and under-counted a
        # loaded one.)
        if self.info is not None and not self.open_arrival:
            # COUNT units throughout: the board's n is count-denominated, so
            # in weighted mode the executed estimate must come from the
            # pre-overlay count vectors (n_w - queued_w is executed work in
            # reference units — writing that into n would double-scale on
            # the next view's re-pricing).
            if xcell:
                done_est = 0.0  # no local row; the record is dropped anyway
            else:
                base_n = view.ntasks if view.ntasks is not None else view.n_view
                base_q = view.qtasks if view.qtasks is not None else view.queued
                done_est = max(
                    float(base_n[vloc]) - float(base_q[vloc]), 0.0
                )
        if not result:
            self._failed_steals += 1
            # Table 1 row 3: thief marks the victim position dirty anyway —
            # with n_j corrected to what the snapshot implies.
            if self.info is not None:
                if self.open_arrival:
                    corrected_n = float(observed_left)
                else:
                    corrected_n = done_est + float(observed_left)
                nc_corr = None
                if self.weighted and observed_left == 0:
                    # The snapshot proved the queue empty: the stale class
                    # profile goes with it.
                    nc_corr = np.zeros(self.num_classes, dtype=np.float64)
                self.info.record_remote(
                    i, plan.victim, float(corrected_n),
                    self.info.belief_t(i, plan.victim),
                    nc_j=nc_corr,
                )
            self.policy.on_steal_result(view, plan, 0, left)
            return False
        # ---- transport leg (DESIGN.md §Fault fabric / §Topology plane) ----
        # A priced plan pays its fare AFTER the claim, overlapped with the
        # victim's compute: the loot is in flight while the thief sleeps the
        # modeled transfer time, then lands on its deque — mirroring the
        # simulator's claim-now/land-later event.  Zero-cost links skip the
        # stall entirely (bit-for-bit the instant-transfer scheduler).
        fare = 0.0
        if self.topology is not None and plan.delay > 0.0:
            # Fare on the ACTUAL take (the plan priced plan.amount).
            fare = max(float(self.topology.cost(plan.victim, i, got)), 0.0)
        if nf is not None and self._t0 is not None:
            tnow = self.clock() - self._t0
            fare += nf.extra_delay(plan.victim, i, tnow)
            pd = nf.drop_prob(plan.victim, i, tnow)
            if pd > 0.0 and float(self.workers[i].nf_rng.random()) < pd:
                # Transfer leg dropped: the loot never lands.  Hardened, the
                # thief waits out the LEASE and the tasks RETURN to the
                # victim — every task still executes exactly once, just
                # later.  The threaded plane carries real payloads, so even
                # the un-hardened ablation returns them (immediately, no
                # lease wait) instead of destroying work — the delivery-
                # semantics table records this divergence from the sim.
                with self._log_lock:
                    self._lease_expired += 1
                if nf.hardened:
                    _sleep_stall(nf.lease_timeout, self.clock)
                self.workers[plan.victim].deque.push(result.tasks)
                if nf.hardened:
                    self._link_health.record(
                        i, plan.victim, False, self.clock() - self._t0
                    )
                if self.info is not None:
                    # Belief restore: the victim has its queue back.
                    if self.open_arrival:
                        corrected_n = float(observed_left)
                    else:
                        corrected_n = done_est + float(observed_left)
                    self.info.record_remote(
                        i, plan.victim, float(corrected_n),
                        self.info.belief_t(i, plan.victim),
                    )
                self.policy.on_steal_result(view, plan, 0, observed_left)
                return False
            if nf.hardened and self._nf_lossy:
                self._link_health.record(i, plan.victim, True, tnow)
        if fare > 0.0:
            _sleep_stall(fare, self.clock)
            with self._log_lock:
                self._fare_paid += fare
        self.workers[i].deque.push(result.tasks)
        with self._log_lock:
            self._steal_log.append((self.clock(), i, plan.victim, got))
        if self.info is not None:
            if self.open_arrival:
                # Depth semantics: the snapshot IS the depth at steal time.
                victim_n_new = float(left)
            else:
                # Same reconciliation as above, post-transfer: the steal
                # moved queued tasks, the victim's executed count is
                # untouched, and `left` is the observed remaining queue.
                victim_n_new = done_est + float(left)
            nc_corr = None
            if self.weighted:
                # The thief saw the classes of the loot first-hand: subtract
                # them from the victim's published profile (clamped — the
                # profile may have been stale already).
                base_nc = self.info.belief_nc(i, plan.victim)
                if base_nc is not None:
                    nc_corr = np.maximum(
                        base_nc - self._class_counts(result.tasks), 0.0
                    )
            # Table 1 row 2: thief refreshes its own and the victim's cells.
            self._update_info(i)
            self.info.record_remote(
                i, plan.victim, float(victim_n_new),
                self.info.belief_t(i, plan.victim),
                nc_j=nc_corr,
            )
        self.policy.on_steal_result(view, plan, got, left)
        return True


def _sleep_stall(duration: float, clock: Callable[[], float]) -> None:
    """Stall for ``duration`` clock seconds while YIELDING the core (models
    throttled/IO-stalled stragglers; contrast ``_busy_wait``, which models a
    co-located compute thief).  Clock-deadline paced so virtual clocks see
    the same stall that was priced."""
    if duration <= 0:
        return
    deadline = clock() + duration
    while True:
        remaining = deadline - clock()
        if remaining <= 0.0:
            return
        time.sleep(min(remaining, 1e-3))


def _busy_wait(duration: float, clock: Callable[[], float]) -> None:
    """Burn CPU for ``duration`` seconds (models co-located thread
    interference — a sleep would free the core, a real leader does not)."""
    if duration <= 0:
        return
    end = clock() + duration
    while clock() < end:
        pass


# The paper's runtime is the pool under its own policy: ``A2WSRuntime(...)``
# constructs a ``WorkerPool`` with the default ``policy="a2ws"``.
A2WSRuntime = WorkerPool
