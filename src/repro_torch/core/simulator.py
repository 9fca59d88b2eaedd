"""Discrete-event simulator: the virtual-time plane of the policy substrate.

Reproduces the paper's experimental setup (§4) deterministically and fast:
SDumont nodes throttled to {1,2,4,8,16,24} cores via SLURM heterogeneous jobs
(Table 2 configurations C1-C5), tasks = seismic shots of equal work, node
speed proportional to core count (the shot solver scales over cores; Fig. 5's
task-count ratios ~24x between 24-core and 1-core nodes confirm this model).

The simulator advances *virtual time* through an event heap, and it drives
the exact same ``SchedPolicy`` objects (``repro.core.policy``) as the
threaded ``WorkerPool`` — A2WS, CTWS, LW and random work-stealing all run on
one event loop, so the paper's mathematics is tested once and measured twice
and every policy is available in both the real-time and virtual-time planes
with identical telemetry (DESIGN.md §Policy layer).  Open-arrival modes
(``poisson``/``trace``) work for every policy.

Modelled costs (all configurable):

* task duration         = task_cost / speed_i * lognormal(noise)
                          * policy.task_multiplier(i)  (LW leader co-location)
* info propagation      : ring policies only.  Process i's view of process j
                          lags by the ring distance d(i,j): each relay
                          forwards at its own task boundaries, so per-hop
                          delay = hop_latency + half the relay's current mean
                          task time.  Radius R caps the window (Eq. 5) —
                          beyond R there is NO information.
* info send overhead    : comm_cell_cost * cells per boundary (grows with R —
                          the Fig. 4 tradeoff; ring policies only).
* steal                 : round-trip steal_latency + per-task payload cost;
                          claimed tasks leave the victim at decision time and
                          reach the thief after the transfer delay.  A policy
                          may price the dispatch itself (``StealPlan.delay``,
                          LW's leader round-trip), which then replaces the
                          default transport cost.
* CTWS token            : hop gate = token_base + token_per_node * P; only
                          the holder steals (half of the most-loaded victim),
                          and busy holders forward the token at task
                          boundaries — exactly like the threaded plane.
* LW                    : serialized leader (service time per request +
                          request round-trip); worker 0 runs slower by
                          leader_overhead (the co-located distributor
                          thread) and co-hosts the central queue.
"""

from __future__ import annotations

import heapq
import math
from bisect import bisect_right
from collections import deque as _deque
from dataclasses import dataclass, field, replace

import numpy as np

from .a2ws import DEFAULT_QS, latency_percentiles
from .deque import SLO_NAMES
from .limp import (
    LimpConfig,
    LimpState,
    SlowdownSchedule,
    effective_heartbeat,
    normalize_duration,
)
from .netfault import (
    NF_SEED_SALT,
    LinkHealth,
    NetFaultSchedule,
)
from .netfault import validate_netfaults as _check_netfaults
from .policy import PolicyView, SchedPolicy, make_policy
from .steal import OverlayBuffers, neighborhood, weighted_overlay
from .topology import Topology

__all__ = [
    "SimAutoscale",
    "SimConfig",
    "SimResult",
    "table2_speeds",
    "simulate",
    "sim_policy",
    "CORE_STEPS",
]

CORE_STEPS = (24, 16, 8, 4, 2, 1)  # descending, process 0 = fastest (Fig. 5)

# Table 2: how many nodes of each core count per configuration.
_TABLE2 = {
    # cores:      1   2   4   8  16  24
    "C1": {1: 2, 2: 1, 4: 1, 8: 1, 16: 1, 24: 2},  # 8 nodes
    "C2": {1: 4, 2: 2, 4: 2, 8: 2, 16: 2, 24: 4},  # 16 nodes
    "C3": {1: 8, 2: 4, 4: 4, 8: 4, 16: 4, 24: 8},  # 32 nodes
    "C4": {1: 16, 2: 8, 4: 8, 8: 8, 16: 8, 24: 16},  # 64 nodes
    "C5": {1: 32, 2: 16, 4: 16, 8: 16, 16: 16, 24: 32},  # 128 nodes
}


def table2_speeds(config: str, order: str = "interleaved") -> np.ndarray:
    """Node speed vector for configuration C1..C5.

    ``order`` is the launcher's RANK PLACEMENT policy — a knob the paper
    never discusses but which dominates radius-limited work-stealing:

    * ``"interleaved"`` (default): round-robin across core classes, so every
      radius-R window contains a representative speed mix and the local
      fair-share (Eq. 5) approximates the global one.  This is what our
      launcher does on a real cluster and what reproduces the paper's gains.
    * ``"blocked"``: SLURM-het-job-style blocks of equal nodes (fastest
      first, process 0 = fastest as in Fig. 5).  Adversarial for small R:
      windows deep inside a slow block see no fast nodes — kept as the
      placement ablation in ``benchmarks/``.
    """
    counts = dict(_TABLE2[config])
    speeds: list[float] = []
    if order == "blocked":
        for cores in CORE_STEPS:
            speeds.extend([float(cores)] * counts[cores])
    elif order == "interleaved":
        while any(v > 0 for v in counts.values()):
            for cores in CORE_STEPS:
                if counts[cores] > 0:
                    speeds.append(float(cores))
                    counts[cores] -= 1
    else:
        raise ValueError(f"unknown placement order {order!r}")
    return np.asarray(speeds, dtype=np.float64)


@dataclass(frozen=True)
class SimAutoscale:
    """Virtual-time replica autoscaling (DESIGN.md §SLO serving).

    ``reserve`` names dormant nodes (by speed) appended after the base ring;
    the scaler activates them in order and deactivates them LIFO.  Every
    ``interval`` virtual seconds a "scale" event evaluates one of two modes:

    * ``"threshold"`` — the PR-3 rule, ported from the threaded
      ``AutoscaleConfig``: scale OUT one reserve when the pending backlog
      (arrived − done, queued + in flight) exceeds
      ``high_pending_per_replica ×`` live nodes; scale IN one reserve after
      ``idle_ticks_to_retire`` consecutive zero-backlog ticks.  Purely
      reactive: it waits for the queue to already be deep.
    * ``"predictive"`` — Holt's EWMA level+trend forecast of the ARRIVAL
      RATE: per tick, the observed rate ``(arrived − prev)/interval``
      updates ``level`` (smoothing ``rate_alpha``) and ``trend``
      (smoothing ``trend_beta``); the forecast ``λ̂ = level + trend·horizon``
      is converted to a node count by requiring aggregate service capacity
      ``Σ_j speed_j / E[task seconds] ≥ λ̂ / target_util``.  Reserves
      activate as soon as the FORECAST crosses capacity — ahead of the
      backlog a threshold scaler waits for — and deactivate (one per tick,
      only while the backlog is small) when the forecast recedes.

    The scaler consumes NO scheduler rng and pushes no events when unset —
    ``autoscale=None`` is bit-for-bit the PR-9 event stream.
    """

    reserve: tuple[float, ...]
    interval: float = 1.0
    mode: str = "threshold"
    high_pending_per_replica: float = 4.0
    idle_ticks_to_retire: int = 3
    rate_alpha: float = 0.3
    trend_beta: float = 0.2
    horizon: float = 5.0
    target_util: float = 0.75


@dataclass(frozen=True)
class SimConfig:
    speeds: np.ndarray
    num_tasks: int
    task_cost: float = 60.0  # seconds of work per task at speed 1.0
    noise: float = 0.03
    seed: int = 0
    # --- ring policies (A2WS) ---
    radius: int | None = None  # None -> 20% of P (paper's operating point)
    hop_latency: float = 2e-3
    # §2.1: info is forwarded "during the task execution if the application
    # allows it" (the seismic app does) — relays poll every ``info_poll``
    # virtual seconds, so per-hop delay is NOT bound to task boundaries.
    info_poll: float = 0.25
    comm_cell_cost: float = 3e-4
    steal_latency: float = 2e-2
    steal_per_task: float = 2e-3
    retry_interval: float = 5e-2
    # --- open arrivals (DESIGN.md §Open-arrival; all policies) ---
    # "closed": the paper's workload — all tasks present at t=0 (§2.2.1).
    # "poisson": num_tasks tasks arrive with Exp(1/arrival_rate) gaps and are
    #            routed by the policy (round-robin spray by default, the
    #            central queue for LW).
    # "trace":   arrival_trace gives the absolute arrival times verbatim.
    arrival: str = "closed"
    arrival_rate: float = 0.0  # tasks/second entering the system (poisson)
    # Absolute times (trace mode).  Array-likes welcome — a 10^6-request
    # diurnal trace streams straight from the generator/npz as a float64
    # array, never materialising a Python tuple.
    arrival_trace: "tuple[float, ...] | np.ndarray" = ()
    # --- elastic membership (DESIGN.md §Elasticity) ---
    # joins:   (time, speed) scale-out events — each activates ONE new node
    #          appended to the ring at that virtual time; it starts with an
    #          empty queue and pulls work through the policy's own steal
    #          path (preemptive estimates cover it exactly like boot).
    # retires: (time, node) graceful drains — the node finishes its
    #          in-flight task, its queued tasks are re-sprayed over the live
    #          nodes, and its ring position is tombstoned.
    joins: tuple[tuple[float, float], ...] = ()
    retires: tuple[tuple[float, int], ...] = ()
    # --- work-weighted cost classes (DESIGN.md §Work-weighted stealing) ---
    # class_cost:  per-class task-duration multipliers (variable-cost
    #              workloads, e.g. bimodal seismic shots: (1.0, 8.0)).
    #              () = the paper's homogeneous tasks — nothing changes,
    #              not even the rng stream.
    # class_probs: workload mix (must sum to 1; () = uniform over classes).
    # class_trace: explicit per-task class assignment (len == num_tasks;
    #              overrides class_probs) — clustered-cost workloads, e.g. a
    #              deep-shot survey line landing in one partition block.
    # weighted:    publish per-class queue counts + EWMA t̂[c] through the
    #              info plane so ring policies price queues in work-seconds;
    #              False keeps the info plane count-based while tasks still
    #              COST class_cost — the ablation baseline.
    # ewma_alpha:  smoothing of the per-class runtime estimates.
    class_cost: tuple[float, ...] = ()
    class_probs: tuple[float, ...] = ()
    class_trace: tuple[int, ...] = ()
    weighted: bool = True
    ewma_alpha: float = 0.25
    # --- straggler/limplock plane (DESIGN.md §Straggler plane) ---
    # slowdowns: scripted degraded-but-alive faults — a SlowdownSchedule (or
    #            a bare tuple of SlowdownEvent) multiplying task durations on
    #            the targeted nodes, the straggler analogue of joins/retires.
    # limp:      adaptive limp DETECTION + response (LimpConfig); None keeps
    #            the scheduler blind to stragglers — the count-based
    #            ablation baseline, and bit-for-bit the pre-PR behaviour.
    slowdowns: SlowdownSchedule | tuple = ()
    limp: LimpConfig | None = None
    # --- topology plane (DESIGN.md §Topology plane) ---
    # topology:       network-cost model.  When set, a steal's loot travels
    #                 cost(victim, thief, take) virtual seconds on the link
    #                 (overlapped with thief compute) instead of the flat
    #                 steal_latency/steal_per_task default; a link priced at
    #                 0.0 falls back to the default transport, so the
    #                 all-zero topology is bit-for-bit topology=None.  With
    #                 contention > 0 a started transfer keeps its directed
    #                 link busy for cost·contention seconds and later
    #                 transfers on the same link queue behind it.
    # topology_aware: False = BLIND ablation — transport is still charged by
    #                 the model, but the policy never sees transfer_cost, so
    #                 it plans exactly as if the network were free.
    topology: Topology | None = None
    topology_aware: bool = True
    # --- network-fault plane (DESIGN.md §Fault fabric) ---
    # netfaults: scriptable lossy-link/partition schedule (NetFaultSchedule).
    #            Steal requests and loot transfers roll against per-link
    #            drop_prob (a DEDICATED rng stream — the scheduler stream is
    #            untouched), pay extra_delay, and cannot cross an active
    #            partition.  Hardening (leases, backoff, link-health
    #            weighting) rides on the schedule's own knobs; None — or an
    #            empty schedule — is bit-for-bit the fault-free scheduler.
    netfaults: NetFaultSchedule | None = None
    # --- SLO serving (DESIGN.md §SLO serving; open-arrival modes only) ---
    # slo_trace:     per-task SLO class (0 = batch, 1 = latency; array-likes
    #                welcome), aligned with the arrival order.  () disables
    #                the whole plane — bit-for-bit the PR-9 scheduler.
    # slo_deadlines: per-class latency BUDGET seconds (batch, latency); a
    #                task's absolute deadline is arrival + budget, so EDF
    #                within a class coincides with FIFO (budgets are
    #                per-class constants).  inf = no deadline (telemetry
    #                still splits per class).
    # slo_order:     owners pop SLO-ordered (latency jumps batch, EDF within
    #                class); False records per-class telemetry but keeps
    #                PR-9 LIFO pops — the ordering ablation.
    # slo_aging:     batch no-starvation bound: a batch task older than this
    #                is promoted into the EDF order at effective deadline
    #                arrival + slo_aging.  inf = never promote.
    # record_tasks:  False skips the per-task (node, start, end) records —
    #                at 10^6 requests they dominate memory and no benchmark
    #                reads them.
    slo_trace: "tuple[int, ...] | np.ndarray" = ()
    slo_deadlines: tuple[float, float] = (math.inf, math.inf)
    slo_order: bool = True
    slo_aging: float = math.inf
    record_tasks: bool = True
    # --- autoscaling (DESIGN.md §SLO serving; open-arrival modes only) ---
    autoscale: "SimAutoscale | None" = None
    # --- CTWS ---
    token_base: float = 2e-3
    token_per_node: float = 2.5e-4
    # --- LW ---
    request_rtt: float = 8e-3
    leader_service: float = 4e-3
    leader_overhead: float = 0.18

    @property
    def P(self) -> int:
        return len(self.speeds)

    def with_(self, **kw) -> "SimConfig":
        new = replace(self, **kw)
        # Fail fast on a mis-scripted fault plan (mirrors the simulate()-time
        # retire-before-join rejection): with_() is how benchmark grids and
        # tests derive scenario configs, so a bad slowdown script should blow
        # up where it is WRITTEN, not runs later inside the event loop.
        validate_slowdowns(new)
        validate_netfaults(new)
        return new


def slowdown_schedule(cfg: "SimConfig") -> SlowdownSchedule:
    """Normalise ``cfg.slowdowns`` (schedule or bare event tuple)."""
    s = cfg.slowdowns
    if isinstance(s, SlowdownSchedule):
        return s
    return SlowdownSchedule(tuple(s))


def validate_slowdowns(cfg: "SimConfig") -> SlowdownSchedule:
    """Reject slowdown events that target never-joined or already-retired
    workers — a fault script slowing a ghost would be silently inert (the
    tombstone guard drops its effect), exactly the failure mode PR 3's
    retire-before-join rejection closed for churn scripts."""
    sched = slowdown_schedule(cfg)
    if not sched.events:
        return sched
    p0 = cfg.P
    joins = sorted(cfg.joins)
    pmax = p0 + len(joins)
    first_retire: dict[int, float] = {}
    for t_ret, node in cfg.retires:
        t_prev = first_retire.get(node)
        if t_prev is None or t_ret < t_prev:
            first_retire[node] = t_ret
    for ev in sched.events:
        if ev.worker >= pmax:
            raise ValueError(
                f"slowdown target {ev.worker} outside the ring "
                f"0..{pmax - 1}: that worker never joins"
            )
        if ev.worker >= p0 and ev.start < joins[ev.worker - p0][0]:
            raise ValueError(
                f"slowdown of node {ev.worker} at t={ev.start} precedes "
                f"its join at t={joins[ev.worker - p0][0]}"
            )
        t_ret = first_retire.get(ev.worker)
        if t_ret is not None and ev.start >= t_ret:
            raise ValueError(
                f"slowdown of node {ev.worker} at t={ev.start} targets a "
                f"worker already retired at t={t_ret}"
            )
    return sched


def validate_netfaults(cfg: "SimConfig") -> None:
    """Reject fault scripts naming workers outside the final ring — a
    partition isolating a ghost would be silently inert (same failure mode
    the slowdown validation closes)."""
    if cfg.netfaults is not None:
        _check_netfaults(cfg.netfaults, cfg.P + len(cfg.joins))


@dataclass
class SimResult:
    makespan: float
    per_node_tasks: list[int]
    per_node_busy: list[float]
    steals: int
    failed_steals: int
    moved_tasks: int
    records: list[tuple[int, float, float]] = field(default_factory=list)
    # records: (node, start, end) per task, for Fig. 5 style plots
    latencies: list[float] = field(default_factory=list)
    # per-task arrival-to-completion sojourn times (open-arrival modes only)
    limp_events: list[tuple[float, int, bool]] = field(default_factory=list)
    # (time, node, flagged) limp-detector transitions (cfg.limp runs only)
    steal_log: list[tuple[float, int, int, int]] = field(default_factory=list)
    # (time, thief, victim, take) per successful steal — lets a caller
    # attribute moved tasks to links/cells (topology benchmarks)
    boundaries: int = 0
    # total policy consultations (view builds) — overhead denominator
    net_failed: int = 0
    # steal requests lost to link drops / partitions (netfaults runs only)
    lease_expired: int = 0
    # dropped loot transfers whose lease expired and returned to the victim
    lost_tasks: int = 0
    # tasks lost in flight — ONLY possible under netfaults.hardened=False
    # (the no-lease ablation); the hardened path conserves every task
    slo_latencies: dict[str, list[float]] = field(default_factory=dict)
    # per-SLO-class sojourn times keyed by class name; {} when cfg.slo_trace
    # is unset (the telemetry split rides the SLO plane, not the ordering)
    slo_violations: dict[str, int] = field(default_factory=dict)
    # per-SLO-class deadline violations (latency > class budget)
    scale_log: list[tuple[float, str, int, int]] = field(default_factory=list)
    # (time, "out" | "in", node, pending) autoscaler actions (cfg.autoscale)

    def latency_percentiles(
        self, qs: tuple[float, ...] = DEFAULT_QS
    ) -> dict[float, float]:
        """Per-task latency percentiles (open-arrival serving metric)."""
        return latency_percentiles(self.latencies, qs)

    def slo_violation_rate(self) -> dict[str, float]:
        """Per-SLO-class violation rate; {} when the SLO plane is off."""
        return {
            name: self.slo_violations.get(name, 0) / max(len(lats), 1)
            for name, lats in self.slo_latencies.items()
        }

    def summary(self) -> str:
        out = (
            f"makespan={self.makespan:.2f}s steals={self.steals} "
            f"failed={self.failed_steals} moved={self.moved_tasks}"
        )
        pct = self.latency_percentiles()
        if pct:
            out += " lat[p50/p95/p99/p99.9]=" + "/".join(
                f"{pct[q]:.2f}s" for q in DEFAULT_QS
            )
        if self.slo_latencies:
            out += " slo[" + " ".join(
                f"{name}={self.slo_violations.get(name, 0)}"
                f"/{len(lats)}viol"
                for name, lats in sorted(self.slo_latencies.items())
            ) + "]"
        if self.scale_log:
            outs = sum(1 for _, k, _n, _p in self.scale_log if k == "out")
            out += f" scale[{outs}out/{len(self.scale_log) - outs}in]"
        return out


# --------------------------------------------------------------------------- #
#                       generic policy-driven event loop                       #
# --------------------------------------------------------------------------- #


class _History:
    """Append-only (time, n, t[, nc, tc]) history per node for delayed views.

    ``num_classes > 0`` additionally records the per-class queue counts and
    EWMA runtime estimates published at each report (work-weighted mode) —
    a remote reader sees the class profile from the SAME report as the
    scalars, i.e. one consistent ring cell."""

    __slots__ = ("times", "ns", "ts", "ncs", "tcs", "limps")

    def __init__(self, num_classes: int = 0) -> None:
        self.times: list[float] = [0.0]
        self.ns: list[float] = [0.0]
        self.ts: list[float] = [float("nan")]
        self.limps: list[bool] = [False]
        if num_classes > 0:
            self.ncs: list[np.ndarray] | None = [np.zeros(num_classes)]
            self.tcs: list[np.ndarray] | None = [
                np.full(num_classes, float("nan"))
            ]
        else:
            self.ncs = self.tcs = None

    def append(
        self,
        time: float,
        n: float,
        t: float,
        nc: np.ndarray | None = None,
        tc: np.ndarray | None = None,
        limp: bool = False,
    ) -> None:
        self.times.append(time)
        self.ns.append(n)
        self.ts.append(t)
        self.limps.append(limp)
        if self.ncs is not None:
            self.ncs.append(self.ncs[-1] if nc is None else nc)
            self.tcs.append(self.tcs[-1] if tc is None else tc)

    def at(self, time: float) -> tuple[float, float]:
        k = bisect_right(self.times, time) - 1
        return self.ns[k], self.ts[k]

    def at_classes(
        self, time: float
    ) -> tuple[float, float, np.ndarray, np.ndarray]:
        k = bisect_right(self.times, time) - 1
        return self.ns[k], self.ts[k], self.ncs[k], self.tcs[k]

    def limp_at(self, time: float) -> bool:
        """Delayed limp flag — rides the same report stream as (n, t)."""
        k = bisect_right(self.times, time) - 1
        return self.limps[k]


def _ring_dist(i: int, j: int, p: int) -> int:
    d = abs(i - j)
    return min(d, p - d)


def _arrival_times(cfg: SimConfig, rng: np.random.Generator) -> np.ndarray:
    """Absolute arrival times for the open-arrival modes."""
    if cfg.arrival == "poisson":
        if cfg.arrival_rate <= 0.0:
            raise ValueError("poisson arrivals need arrival_rate > 0")
        gaps = rng.exponential(1.0 / cfg.arrival_rate, cfg.num_tasks)
        return np.cumsum(gaps)
    if cfg.arrival == "trace":
        # Accept array-likes and avoid the Python-object sort that dominated
        # ingestion at 10^6 events: one vectorised monotonicity check IS the
        # validation, and np.sort runs only when the trace is out of order.
        arr = np.asarray(cfg.arrival_trace, dtype=np.float64)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("trace arrivals need a non-empty 1-D arrival_trace")
        if not np.isfinite(arr).all():
            raise ValueError("arrival_trace times must all be finite")
        if arr.size > 1 and bool((arr[1:] < arr[:-1]).any()):
            arr = np.sort(arr)
        elif arr is cfg.arrival_trace:
            arr = arr.copy()  # never alias caller memory into the event loop
        return arr
    raise ValueError(f"not an open-arrival mode: {cfg.arrival!r}")


def sim_policy(spec: str | SchedPolicy, cfg: SimConfig) -> SchedPolicy:
    """Resolve a policy spec against the simulator's cost model (the plane
    owns the policy *parameters* — hop gates, leader service — because they
    are measured quantities of the modelled cluster, not of the policy).

    Name dispatch itself lives in ``policy.make_policy`` (the single
    registry); this only translates SimConfig costs into the named policy's
    constructor kwargs, so a new registered policy without sim-specific
    costs is simulatable with no change here.
    """
    if isinstance(spec, SchedPolicy):
        return spec
    kw: dict = {}
    if spec == "ctws":
        kw = {"hop_time": cfg.token_base + cfg.token_per_node * cfg.P}
    elif spec == "lw":
        kw = {
            "leader_overhead": cfg.leader_overhead,
            "service_time": cfg.leader_service,
            "request_rtt": cfg.request_rtt,
        }
    return make_policy(spec, cfg.P, **kw)


class _SloQueue:
    """Two-class task-id queue: the simulator's O(1) mirror of the threaded
    ``TaskDeque.get_task(key)`` scan (DESIGN.md §SLO serving).

    The threaded owner scans ``[head, tail)`` for the minimum SLO key; at
    trace scale that scan is O(depth) per pop, so the simulator keeps the
    two classes in separate deques and the SLO choice becomes a two-way
    comparison.  Orientation matches the plain deque it replaces: left =
    newest (arrivals land, owner's LIFO end), right = oldest (thief end).

    * ``popleft(now)`` — the OWNER pop: latency first in EDF order (per-class
      constant budgets make EDF ≡ oldest-first), with a batch task older
      than ``aging`` promoted at effective deadline ``arrival + aging``;
      batch-only pops stay newest-first (LIFO), exactly the plain pop.
    * ``pop()`` — the THIEF end: oldest BATCH first, then oldest latency —
      steals strip batch work preferentially (owner-vs-thief asymmetry).
    * ``[-1]`` — what ``pop()`` would take next (work-greedy loot pricing).
    """

    __slots__ = ("lat", "bat", "slo", "arrival", "deadline", "aging")

    def __init__(
        self,
        slo: np.ndarray,
        arrival: np.ndarray,
        deadline: np.ndarray,
        aging: float,
    ) -> None:
        self.lat: _deque = _deque()
        self.bat: _deque = _deque()
        self.slo = slo
        self.arrival = arrival
        self.deadline = deadline
        self.aging = aging

    def __len__(self) -> int:
        return len(self.lat) + len(self.bat)

    def __bool__(self) -> bool:
        return bool(self.lat) or bool(self.bat)

    def __iter__(self):
        yield from self.lat
        yield from self.bat

    def __getitem__(self, idx: int):
        if idx != -1:
            raise IndexError("_SloQueue exposes only the thief end [-1]")
        if self.bat:
            return self.bat[-1]
        return self.lat[-1]

    def extendleft(self, tids) -> None:
        lat_l, bat_l, slo = self.lat.appendleft, self.bat.appendleft, self.slo
        for tid in tids:
            (lat_l if slo[tid] else bat_l)(tid)

    def extend(self, tids) -> None:
        lat_a, bat_a, slo = self.lat.append, self.bat.append, self.slo
        for tid in tids:
            (lat_a if slo[tid] else bat_a)(tid)

    def popleft(self, now: float) -> int:
        lat, bat = self.lat, self.bat
        if bat:
            b = bat[-1]  # oldest batch task
            aged = (
                self.aging < math.inf
                and (now - float(self.arrival[b])) > self.aging
            )
            if not lat:
                return bat.pop() if aged else bat.popleft()
            if aged and (
                float(self.arrival[b]) + self.aging
                <= float(self.deadline[lat[-1]])
            ):
                return bat.pop()  # the promoted batch task wins the EDF race
        return self.lat.pop()  # EDF: oldest latency = earliest deadline

    def pop(self) -> int:
        if self.bat:
            return self.bat.pop()
        return self.lat.pop()

    def clear(self) -> None:
        self.lat.clear()
        self.bat.clear()


def simulate(policy: str | SchedPolicy, cfg: SimConfig) -> SimResult:
    """Run ``cfg`` under ``policy`` ("a2ws" | "ctws" | "lw" | "random", or a
    ready ``SchedPolicy`` instance) on the virtual-time substrate."""
    pol = sim_policy(policy, cfg)
    p0 = cfg.P
    rng = np.random.default_rng(cfg.seed)

    # Straggler plane: scripted slowdown faults (always honoured) and the
    # adaptive limp detector (opt-in via cfg.limp; when None the `limping`
    # mask stays all-False and every downstream branch is inert — the
    # count-based ablation is bit-for-bit the pre-straggler behaviour).
    sched = validate_slowdowns(cfg)
    has_slow = bool(sched.events)
    detect = cfg.limp is not None

    # Network-fault plane (DESIGN.md §Fault fabric): drop/delay/partition
    # rolls come from a DEDICATED rng stream — the scheduler stream is never
    # consulted, and every roll is gated on drop_prob > 0, so an empty
    # schedule is bit-for-bit netfaults=None (tests/test_netfault.py).
    nf = cfg.netfaults
    validate_netfaults(cfg)
    nf_rng = (
        np.random.default_rng(cfg.seed + NF_SEED_SALT) if nf is not None else None
    )
    health = LinkHealth(nf) if nf is not None else None
    nf_lossy = nf is not None and nf.lossy()

    # Topology plane (DESIGN.md §Topology plane): the network-cost model and
    # the per-directed-link busy-until horizon (contention serialization).
    topo = cfg.topology
    if topo is not None and cfg.topology_aware:
        # The blind ablation must NOT bind: the policy (including the
        # hierarchical leader balancer) plans as if loot moved for free.
        pol.bind_topology(topo)
    link_busy: dict[tuple[int, int], float] = {}

    # Autoscale plane (DESIGN.md §SLO serving): reserve nodes occupy the
    # ring positions a scripted join would, so combining both would make
    # slot ownership ambiguous — rejected.  The scaler is the churn driver.
    scaler = cfg.autoscale
    if scaler is not None:
        if cfg.arrival == "closed":
            raise ValueError("autoscale needs an open-arrival mode")
        if cfg.joins:
            raise ValueError(
                "autoscale and scripted joins are mutually exclusive"
            )
        if not scaler.reserve:
            raise ValueError("autoscale needs at least one reserve node")
        if scaler.mode not in ("threshold", "predictive"):
            raise ValueError(f"unknown autoscale mode {scaler.mode!r}")
        if scaler.interval <= 0.0:
            raise ValueError("autoscale interval must be > 0")
        if getattr(pol, "cells", None) is not None:
            raise NotImplementedError(
                "autoscale under a hierarchical policy: reserve homing is "
                "not implemented (flat policies only)"
            )

    # Elastic membership: every join appends one ring position, so all
    # per-node state is sized for the FINAL ring up front; `p` is the
    # currently-materialised prefix and `alive_sim` masks live members.
    joins = sorted(cfg.joins)
    reserve = tuple(scaler.reserve) if scaler is not None else ()
    pmax = p0 + len(joins) + len(reserve)
    speeds = np.concatenate(
        [np.asarray(cfg.speeds, np.float64),
         np.asarray([s for _, s in joins], np.float64),
         np.asarray(reserve, np.float64)]
    )
    p = p0
    alive_sim = np.zeros(pmax, bool)
    alive_sim[:p0] = True
    born = np.zeros(pmax, np.float64)  # preemptive-estimate baseline per node

    def _radius_for(active: int) -> int:
        r = cfg.radius if cfg.radius is not None else max(1, round(0.2 * active))
        return min(r, active // 2)

    radius = _radius_for(p0)
    open_mode = cfg.arrival != "closed"
    uses_ring = pol.uses_ring
    # Hierarchy scoping (DESIGN.md §Hierarchy): a cell-mapped policy gets
    # CELL-scoped views — O(ρ) arrays over the cell's local slots instead of
    # O(P) over the whole ring.  The simulator has no board objects (views
    # are rebuilt from report histories), so the CellMap alone carries the
    # topology; joins are homed by the policy's own on_worker_join.
    cells = getattr(pol, "cells", None) if uses_ring else None
    if cells is not None and cells.num_workers != p0:
        raise ValueError(
            f"policy cell map covers {cells.num_workers} workers, "
            f"sim boots {p0}"
        )
    overlay_bufs: dict[int, OverlayBuffers] = {}

    # Work-weighted cost classes: every task is a ``(arrival, class)`` tuple
    # (class 0 when the workload is homogeneous — the legacy float stamp
    # generalised, same rng stream when class_cost is unset).  ``winfo``
    # gates the per-class INFO plane: tasks cost class_cost either way, the
    # flag only decides whether ring policies get to see the classes.
    costs = np.asarray(cfg.class_cost or (1.0,), np.float64)
    ncls = len(costs)
    has_classes = bool(cfg.class_cost)
    # (ncls > 1: a single class carries no composition information and must
    # stay bit-for-bit count-based — the degenerate-case guarantee.)
    winfo = cfg.weighted and has_classes and ncls > 1 and uses_ring

    if open_mode:
        arrivals = _arrival_times(cfg, rng)
        total_tasks = len(arrivals)
    else:
        arrivals = np.empty(0)
        total_tasks = cfg.num_tasks
    if has_classes:
        if cfg.class_trace:
            if len(cfg.class_trace) != total_tasks:
                raise ValueError("class_trace must assign every task a class")
            task_cls = np.asarray(cfg.class_trace, np.int64)
            if task_cls.min() < 0 or task_cls.max() >= ncls:
                raise ValueError("class_trace entries outside [0, num_classes)")
        else:
            if cfg.class_probs:
                if len(cfg.class_probs) != ncls:
                    raise ValueError("class_probs must match class_cost length")
                probs = np.asarray(cfg.class_probs, np.float64)
            else:
                probs = np.full(ncls, 1.0 / ncls)
            task_cls = rng.choice(ncls, size=total_tasks, p=probs)
    else:
        task_cls = np.zeros(total_tasks, np.int64)

    # First-class Task records, column-wise: the simulator's task identity
    # is its integer id; (arrival, cls, slo, deadline) live in parallel
    # arrays so a 10^6-request trace never materialises per-task Python
    # objects (the threaded plane carries the same fields on core.deque.Task
    # instances).  `task_arrival` aliases the arrival trace under open mode.
    task_arrival = arrivals if open_mode else np.zeros(total_tasks, np.float64)
    slo_tele = len(cfg.slo_trace) > 0
    budgets = np.asarray(cfg.slo_deadlines, np.float64)
    if slo_tele:
        if not open_mode:
            raise ValueError("slo_trace needs an open-arrival mode")
        task_slo = np.asarray(cfg.slo_trace, np.int8)
        if task_slo.shape != (total_tasks,):
            raise ValueError("slo_trace must assign every task an SLO class")
        if int(task_slo.min()) < 0 or int(task_slo.max()) > 1:
            raise ValueError(
                "slo_trace entries must be 0 (batch) or 1 (latency)"
            )
        if budgets.shape != (2,) or not bool((budgets > 0.0).all()):
            raise ValueError(
                "slo_deadlines must be two positive budgets (batch, latency)"
            )
        task_deadline = task_arrival + budgets[task_slo]
    else:
        task_slo = np.zeros(total_tasks, np.int8)
        task_deadline = np.empty(0)
    if not cfg.slo_aging > 0.0:  # also rejects NaN
        raise ValueError("slo_aging must be > 0 (math.inf disables aging)")
    slo_on = slo_tele and cfg.slo_order
    record_tasks = cfg.record_tasks

    # Per-node queues hold task IDS.  Head = left (owner pops, new arrivals
    # land), tail = right (thieves claim the oldest waiters), matching the
    # TaskDeque discipline of the threaded runtime; with SLO ordering on,
    # the owner end consults the two-lane _SloQueue instead.  Initial
    # placement is the policy's (static block split by default, the central
    # queue for LW).
    queues: list = [
        _SloQueue(task_slo, task_arrival, task_deadline, cfg.slo_aging)
        if slo_on
        else _deque()
        for _ in range(pmax)
    ]
    if not open_mode:
        for i, part in enumerate(pol.partition(list(range(total_tasks)), p0)):
            queues[i].extend(part)

    def depth(i: int) -> int:
        return len(queues[i])

    # Per-queue class counts, maintained INCREMENTALLY at every queue
    # mutation (the O(depth) rescan per published report would make weighted
    # open-arrival runs quadratic in backlog — the threaded plane caches the
    # same scan behind a deque-mutation key).
    qcls = np.zeros((pmax, ncls), np.float64)
    for i, q in enumerate(queues):
        for task in q:
            qcls[i, task_cls[task]] += 1.0

    def q_pop(i: int, left: bool = False, now: float = 0.0):
        if left:
            task = queues[i].popleft(now) if slo_on else queues[i].popleft()
        else:
            task = queues[i].pop()
        qcls[i, task_cls[task]] -= 1.0
        return task

    def q_classes(i: int) -> np.ndarray:
        return qcls[i].copy()

    executed = np.zeros(pmax, np.int64)
    runtime_sum = np.zeros(pmax, np.float64)
    busy = np.zeros(pmax, np.float64)
    class_t = np.full((pmax, ncls), np.nan)  # per-class EWMA runtimes
    hist = [_History(ncls if winfo else 0) for _ in range(pmax)]
    limping = np.zeros(pmax, bool)
    limp_states = [LimpState(cfg.limp) for _ in range(pmax)] if detect else None
    limp_events: list[tuple[float, int, bool]] = []
    # Wedge detector (LimpConfig.stale_after): the OWNER-driven heartbeat —
    # last time each node reported its own cell at a boundary it reached
    # itself.  Thief-side victim publishes (the record_remote analogue) do
    # NOT count: in the threaded plane a steal never bumps the victim's own
    # version, and a wedged node being stolen from must stay flagged.
    wedge = detect and math.isfinite(cfg.limp.stale_after)
    own_report = np.zeros(pmax, np.float64)
    stale_flagged = np.zeros(pmax, bool)

    def cls_payload(i: int) -> dict:
        """Per-class cell payload published alongside every (n, t) report."""
        if not winfo:
            return {}
        return {"nc": q_classes(i), "tc": class_t[i].copy()}

    if uses_ring:
        for i in range(p0):
            hist[i].append(0.0, float(depth(i)), float("nan"), **cls_payload(i))
    cur_t = np.full(pmax, np.nan)  # latest own estimate (for relay pacing)
    pending_dur = np.zeros(pmax, np.float64)  # duration of the task in flight
    pending_task: list = [None] * pmax  # the task id in flight (None: idle)
    idle_since = np.full(pmax, -1.0)
    in_transit = np.zeros(pmax, np.int64)  # loot scheduled but not yet received
    arrived = 0 if open_mode else total_tasks
    records: list[tuple[int, float, float]] = []
    latencies: list[float] = []
    steal_log: list[tuple[float, int, int, int]] = []
    # Per-SLO-class telemetry ({} when the SLO plane is off, so SimResult
    # summaries of plain runs are unchanged).
    slo_lat: dict[str, list[float]] = (
        {name: [] for name in SLO_NAMES} if slo_tele else {}
    )
    slo_viol: dict[str, int] = (
        {name: 0 for name in SLO_NAMES} if slo_tele else {}
    )
    scale_log: list[tuple[float, str, int, int]] = []
    stats = {
        "steals": 0, "failed": 0, "moved": 0, "done": 0, "boundaries": 0,
        "net_failed": 0, "lease": 0, "lost": 0,
    }
    rr_state = [0]  # round-robin router for arrivals / drain re-sprays

    def route(prefer_central: bool = True) -> int:
        """Pick a LIVE landing node (arrival spray / retirement drain) —
        membership changes mean targets must resolve at event time, not at
        trace-generation time.  Flagged-limping nodes are skipped (routing a
        fresh submit onto a collapsed node bakes its slowdown straight into
        that task's latency) unless every live node is limping, in which
        case degrade gracefully rather than drop the task — EXCEPT for the
        probation canaries: every Nth diverted task still lands on the
        flagged node, the only completions that can ever clear its flag
        (LimpConfig.probation_every)."""
        central = pol.central if prefer_central else None
        if central is not None and alive_sim[central]:
            return central
        fallback = -1
        for _ in range(p):
            rr_state[0] = (rr_state[0] + 1) % p
            j = rr_state[0]
            if alive_sim[j]:
                if not limping[j]:
                    return j
                if limp_states is not None and limp_states[j].should_probe():
                    return j  # probation canary
                if fallback < 0:
                    fallback = j
        return fallback  # only limping nodes left (or nobody at all: -1)

    # Event heap: (time, seq, kind, node, payload).  Sequence numbers
    # 0..N-1 are RESERVED for the N open-mode arrival events (arrival k
    # carries seq k), so the lazily-streamed arrival pushes below reproduce
    # exactly the heap order of an eager up-front push of the whole trace;
    # every other event numbers from N.
    heap: list[tuple[float, int, str, int, object]] = []
    seq = total_tasks if open_mode else 0

    arr_cursor = [0]

    def push_arrival() -> None:
        # Stream the arrival trace one event at a time: the heap holds at
        # most ONE pending arrival instead of all 10^6, and the payload is
        # just the task id.
        k = arr_cursor[0]
        if k < total_tasks:
            arr_cursor[0] = k + 1
            heapq.heappush(heap, (float(arrivals[k]), k, "arrive", -1, k))

    def push_event(time: float, kind: str, node: int, payload: object = 0) -> None:
        nonlocal seq
        heapq.heappush(heap, (time, seq, kind, node, payload))
        seq += 1

    def reported_n(i: int) -> float:
        """What node i publishes as n_i: cumulative total in the paper's
        closed workload, instantaneous depth under open arrivals (DESIGN.md
        §Open-arrival — totals are meaningless while tasks keep arriving)."""
        if open_mode:
            return float(depth(i))
        return float(executed[i] + depth(i))

    def start_task(i: int, now: float) -> None:
        if not alive_sim[i]:
            return  # tombstoned/retired: never picks up work again
        if not queues[i]:
            idle_since[i] = now
            push_event(now + cfg.retry_interval, "retry", i, 0)
            return
        task = q_pop(i, left=True, now=now)
        pending_task[i] = task
        dur = cfg.task_cost * float(costs[task_cls[task]]) / speeds[i]
        if cfg.noise:
            dur *= float(rng.lognormal(0.0, cfg.noise))
        dur *= pol.task_multiplier(i)  # LW: co-located leader slows worker 0
        if has_slow:
            # Straggler fault injection: the scripted multiplier, sampled at
            # task START (the threaded plane stalls the same wall-clock way).
            dur *= sched.factor_at(i, now)
        # Sender-side info-communication overhead at the task boundary: the
        # dirty part of the window goes to both neighbours (≤ R cells each).
        # Under a hierarchy the window is the CELL radius — the whole point:
        # per-boundary info cost scales with ρ, not P.
        if uses_ring:
            r_i = radius if cells is None else cells.radius_of(cells.cell_of(i))
            overhead = cfg.comm_cell_cost * 2 * r_i
        else:
            overhead = 0.0
        pending_dur[i] = dur
        push_event(now + overhead + dur, "finish", i)
        busy[i] += dur
        if record_tasks:
            records.append((i, now + overhead, now + overhead + dur))

    def _own_t(i: int, now: float) -> float:
        if executed[i] > 0:
            return runtime_sum[i] / executed[i]
        return max(now - born[i], 1e-9)  # elapsed since the node joined

    def _pub_t(i: int, now: float) -> float:
        """What node i PUBLISHES as its mean task time: the cumulative mean,
        except that a flagged-limping node publishes its collapsed fast-EWMA
        instead — the adaptive RE-PRICING.  Pushing the honest (slow) t_i
        through the ring makes the existing fair-share mathematics (Eq. 5)
        mark the limper as massively surplus, so thieves strip it through
        the ordinary steal path; no new steal rule is needed."""
        t = _own_t(i, now)
        if limping[i]:
            recent = limp_states[i].recent
            if recent == recent:
                t = max(t, recent)
        return t

    def publish(j: int, now: float) -> None:
        """Append node j's current cell to its report history."""
        hist[j].append(
            now, reported_n(j), _pub_t(j, now),
            limp=bool(limping[j]), **cls_payload(j)
        )

    def _peer_ref(i: int, now: float) -> float:
        """Median published t among i's live window peers — the detector's
        reference of last resort for a node limping before it has its own
        baseline (min_samples).  NaN when no peer has reported.  Under a
        hierarchy the peers are i's CELL window — a limper is judged against
        its cell, mirroring the threaded plane's peer_raw_t scoping."""
        if cells is None:
            peers = [j for j in neighborhood(i, p, radius) if j != i]
        else:
            cell, iloc = cells.locate(i)
            mem = cells.members(cell)
            m = len(mem)
            rad = min(cells.radius_of(cell), m // 2)
            peers = [
                mem[jl]
                for jl in neighborhood(iloc, m, rad)
                if jl != iloc and mem[jl] >= 0
            ]
        vals = [
            float(cur_t[j])
            for j in peers
            if alive_sim[j] and cur_t[j] == cur_t[j]
        ]
        if not vals:
            return float("nan")
        return float(np.median(vals))

    def ring_view(i: int, now: float) -> tuple:
        """Delayed (n, t, queued-estimate) views of the window around i,
        plus the ``(unit, qtasks, rel)`` work-weighted overlay (None in
        count mode) and the delayed limp-flag plane — the simulator's
        mirror of ``WorkerPool._ring_view``.

        Under a hierarchy the board is i's CELL: rows are the cell's
        member slots (LOCAL indices, -1 holes from migration/retirement),
        and the relay path walks the cell ring — the O(cell)-not-O(P) hot
        path.  Flat runs take the identical loop with the identity member
        mapping (``g = jl``), so the arithmetic is bit-for-bit the old
        flat builder's."""
        if cells is None:
            mem = None
            m, iloc, rad = p, i, radius
        else:
            cell, iloc = cells.locate(i)
            mem = cells.members(cell)
            m = len(mem)
            rad = min(cells.radius_of(cell), m // 2)
        n_view = np.zeros(m)
        t_view = np.ones(m)
        queued = np.zeros(m)
        limp_view = np.zeros(m, bool) if detect else None
        nc_view = np.zeros((m, ncls)) if winfo else None
        tc_view = np.full((m, ncls), np.nan) if winfo else None
        frozen = np.zeros(m, bool) if winfo else None

        def relay_half_t(g: int) -> float:
            # Relay pacing: per-hop delay = link latency + half the relay's
            # poll interval (relays forward mid-task, §2.1 — capped by poll
            # period, never by the 60 s task duration).  A hole slot has no
            # relay estimate: charge the poll-period cap.
            if g < 0:
                return 0.5 * cfg.info_poll
            t_r = cur_t[g]
            if t_r != t_r:
                t_r = cfg.task_cost / speeds[g]
            return 0.5 * min(float(t_r), cfg.info_poll)

        for off in range(-rad, rad + 1):
            jl = (iloc + off) % m
            g = jl if mem is None else mem[jl]
            if g < 0:
                # Hole slot (migrated-away / compacted member): empty row,
                # speed ~0 so no planner ever targets it.
                t_view[jl] = 1e12
                continue
            if jl == iloc:
                n_view[jl] = reported_n(i)
                t_view[jl] = _pub_t(i, now)  # own row: re-priced when limping
                queued[jl] = depth(i)
                if detect:
                    limp_view[jl] = bool(limping[i])
                if winfo:
                    # Own row is ground truth: actual queue composition +
                    # own EWMA estimates (mirrors the threaded plane).
                    nc_view[jl] = q_classes(i)
                    tc_view[jl] = class_t[i]
                continue
            if not alive_sim[g]:
                # Tombstoned member: frozen cells; count the orphaned queue
                # directly and report speed ~0 (mirrors the threaded plane).
                queued[jl] = depth(g)
                t_view[jl] = 1e12
                n_view[jl] = (
                    queued[jl] if open_mode else executed[g] + queued[jl]
                )
                if winfo:
                    nc_view[jl] = q_classes(g)  # orphans: ground-truth scan
                continue
            d = _ring_dist(iloc, jl, m)
            step = 1 if off > 0 else -1
            delay = 0.0
            for h in range(1, d + 1):
                rl = (iloc + step * h) % m
                rg = rl if mem is None else mem[rl]
                delay += cfg.hop_latency + relay_half_t(rg)
            read_at = max(now - delay, 0.0)
            cut = math.inf
            if nf is not None:
                # Partition gating (DESIGN.md §Fault fabric): no report g
                # published after the cut can have crossed the fabric, so
                # the observer's view of g FREEZES at the cut instant and
                # thaws automatically when the partition heals (reads catch
                # back up to now - delay on their own).
                cut = nf.unreachable_since(g, i, now)
                if cut < read_at:
                    read_at = cut
            if winfo:
                n_j, t_j, nc_j, tc_j = hist[g].at_classes(read_at)
                nc_view[jl] = nc_j
                tc_view[jl] = tc_j
            else:
                n_j, t_j = hist[g].at(read_at)
            if detect:
                limp_view[jl] = hist[g].limp_at(read_at)
            if t_j != t_j:  # no report yet: preemptive wall-time estimate
                t_j = max(now - born[i], 1e-9)  # the THIEF's elapsed time
            if wedge:
                # Heartbeat staleness (LimpConfig.stale_after): g has not
                # reported its own cell for the whole window — it is wedged
                # (slowdown → ∞) and its owner-side EWMA will never flag it.
                # The PEER raises the limp flag and re-prices g's believed
                # speed to the silence itself, so closed-mode done_est → 0
                # and thieves see g's full queue as surplus.
                hb = float(own_report[g])
                if now - hb > cfg.limp.stale_after:
                    if not stale_flagged[g]:
                        stale_flagged[g] = True
                        if not limping[g]:
                            limping[g] = True
                            limp_events.append((now, g, True))
                    t_j = max(t_j, now - hb)
                    limp_view[jl] = True
                elif stale_flagged[g]:
                    # Heartbeat is back: hand the verdict back to the
                    # owner-side EWMA hysteresis.
                    stale_flagged[g] = False
                    verdict = bool(limp_states[g].limping)
                    if bool(limping[g]) != verdict:
                        limping[g] = verdict
                        limp_events.append((now, g, verdict))
            if cut < math.inf:
                # Partition staleness (observer-LOCAL): across a cut the
                # heartbeat the observer can actually see stops at the cut
                # instant, so after nf.stale_after of silence the peer is
                # re-priced to the silence in THIS view row only — thieves
                # on this side stop targeting it while its own component
                # keeps scheduling it (no write to the global limping /
                # stale_flagged state, unlike the wedge path above).
                hb_eff = effective_heartbeat(float(own_report[g]), cut)
                if now - hb_eff > nf.stale_after:
                    t_j = max(t_j, now - hb_eff)
                    if detect:
                        limp_view[jl] = True
            n_view[jl] = n_j
            t_view[jl] = t_j
            if open_mode:
                # n_j IS the reported depth; no elapsed-time extrapolation —
                # depth drains AND refills under arrivals, so decaying it
                # would systematically under-count busy victims.
                queued[jl] = max(n_j, 0.0)
            else:
                done_est = min(now / max(t_j, 1e-9), n_j)
                queued[jl] = max(n_j - done_est, 0.0)
        members = None if mem is None else np.asarray(mem, np.int64)
        if not winfo:
            return (n_view, t_view, queued, None, None, None, limp_view,
                    members, None, iloc, rad)
        # ---- work-weighted overlay (DESIGN.md §Work-weighted stealing) ----
        # steal.weighted_overlay is the ONE shared re-pricing for both
        # planes; tombstones are frozen at their ~0-speed price.  A limping
        # node's collapsed t feeds the overlay like any other estimate, so
        # its queue prices in (slow) work-seconds automatically.
        if mem is None:
            np.logical_not(alive_sim[:p], out=frozen)
        else:
            for jl2, g2 in enumerate(mem):
                frozen[jl2] = g2 < 0 or not alive_sim[g2]
        buf = OverlayBuffers.ensure(overlay_bufs.get(m), m, ncls)
        overlay_bufs[m] = buf
        n_w, t_w, queued_w, unit, qtasks, rel = weighted_overlay(
            n_view, t_view, queued, nc_view, tc_view, frozen=frozen, buf=buf
        )
        return (n_w, t_w, queued_w, unit, qtasks, rel, limp_view,
                members, nc_view, iloc, rad)

    def make_view(i: int, now: float) -> PolicyView:
        unit = qtasks = rel = limp_view = None
        members = nc_view = None
        iview, m, rad = i, p, radius
        if uses_ring:
            (n_view, t_view, queued, unit, qtasks, rel, limp_view,
             members, nc_view, iview, rad) = ring_view(i, now)
            m = p if members is None else len(members)
            window = neighborhood(iview, m, rad)
        else:
            n_view = t_view = queued = None
            window = list(range(p))
        if members is None:
            depth_f = depth
            alive_f = lambda j: bool(alive_sim[j])
        else:
            mem = members
            depth_f = lambda jl: depth(int(mem[jl])) if mem[jl] >= 0 else 0
            alive_f = lambda jl: bool(mem[jl] >= 0 and alive_sim[mem[jl]])
        tcost = None
        if topo is not None and cfg.topology_aware:
            if members is None:
                # transfer_cost(j, k) = seconds to move k tasks FROM j TO i.
                tcost = lambda j, k, _i=i: topo.cost(  # noqa: E731
                    int(j), _i, int(k)
                )
            else:
                # Scoped view: j is a LOCAL slot — translate through the
                # member map; a migration hole is unreachable (inf).
                def tcost(jl, k, _i=i, _mem=members):
                    g = int(_mem[jl]) if 0 <= jl < len(_mem) else -1
                    if g < 0:
                        return float("inf")
                    return topo.cost(g, _i, int(k))
        lh = None
        if nf is not None:
            # link_health(j) ∈ [0, 1]: victim-weight multiplier for thief i
            # stealing from j — 0.0 across an active partition or a
            # backed-off link, the health EWMA (floor-clamped) otherwise.
            # All-1.0 on a healthy fabric, so weights are untouched
            # (steal.victim_weights skips the multiply entirely then).
            if members is None:
                def lh(j, _i=i, _now=now):
                    g = int(j)
                    if not nf.reachable(g, _i, _now):
                        return 0.0
                    return health.factor(_i, g, _now)
            else:
                def lh(jl, _i=i, _now=now, _mem=members):
                    g = int(_mem[jl]) if 0 <= jl < len(_mem) else -1
                    if g < 0 or not nf.reachable(g, _i, _now):
                        return 0.0
                    return health.factor(_i, g, _now)
        return PolicyView(
            worker=iview,
            now=now,
            idle=depth(i) == 0,
            near_idle=depth(i) <= 1,
            ran_any=bool(executed[i] > 0),
            open_arrival=open_mode,
            radius=rad,
            num_workers=m,
            rng=rng,
            window=window,
            depth=depth_f,
            alive=alive_f,
            pending=lambda: arrived - stats["done"],
            n_view=n_view,
            t_view=t_view,
            queued=queued,
            unit=unit,
            qtasks=qtasks,
            rel=rel,
            limp=limp_view,
            inflight=lambda: int(in_transit[i]),
            members=members,
            nc_view=nc_view,
            transfer_cost=tcost,
            link_health=lh,
        )

    def boundary(i: int, now: float) -> bool:
        """Task-boundary policy consultation + steal execution (the
        simulator's analogue of WorkerPool._policy_boundary)."""
        if not alive_sim[i]:
            return False  # tombstoned members take no more boundaries
        stats["boundaries"] += 1
        view = make_view(i, now)
        plan = pol.on_boundary(view)
        if plan is None:
            return False
        v = plan.victim
        if nf is not None:
            # Request leg (thief → victim): a partition loses the probe with
            # certainty — deterministically, NO rng draw, so the scheduler
            # stream is untouched — and a lossy link with drop_prob.  Either
            # way the thief learns nothing about the victim (result 0/0),
            # records the failure in the link-health EWMA (capped
            # exponential backoff zeroes the link's weight for a while) and
            # falls back to the ordinary retry path.
            req_lost = not nf.reachable(i, v, now)
            if not req_lost:
                pd = nf.drop_prob(i, v, now)
                if pd > 0.0 and float(nf_rng.random()) < pd:
                    req_lost = True
            if req_lost:
                stats["failed"] += 1
                stats["net_failed"] += 1
                if nf.hardened:
                    health.record(i, v, False, now)
                pol.on_steal_result(view, plan, 0, 0)
                return False
            if nf.hardened and nf_lossy:
                health.record(i, v, True, now)
        avail = depth(v)  # get-accumulate ground truth at the victim
        if plan.work > 0.0 and view.rel is not None and plan.delay <= 0.0:
            # Work-greedy loot: pop tail tasks until the plan's work target
            # is covered, refusing a candidate whose work would overshoot
            # the target by more than the remaining deficit (mirrors
            # TaskDeque.steal_by_work in the threaded plane).  The cap
            # bounds tasks by ~2x the work target, NOT by the count
            # estimate: a lighter-than-expected tail may take more than
            # plan.amount tasks to fill the planned work.  A PRICED plan
            # (delay > 0, §Topology plane) skips this: its loot moves as
            # ONE batched transfer of exactly the tasks it paid for.
            rel_v = view.rel
            cap = max(plan.amount, int(np.ceil(2.0 * plan.work)))
            stamps = []
            cum = 0.0
            while queues[v] and len(stamps) < cap:
                w_next = float(rel_v[task_cls[queues[v][-1]]])
                if cum + w_next - plan.work > plan.work - cum + 1e-12 and not (
                    view.idle and not stamps  # idle: stay work-conserving
                ):
                    break
                stamps.append(q_pop(v))
                cum += w_next
            take = len(stamps)
        else:
            take = min(plan.amount, avail)
            stamps = [q_pop(v) for _ in range(take)]  # tail: oldest waiters
        if take <= 0:
            stats["failed"] += 1
            pol.on_steal_result(view, plan, 0, avail)
            return False
        if uses_ring:
            publish(v, now)
        # Transport: the topology model's link cost on the ACTUAL take
        # (charged identically whether the policy planned blind or priced —
        # the ablation difference must live in the decisions, not the
        # fare), else the policy-priced dispatch delay (LW round-trip),
        # else the plane's default steal cost.  A zero-priced link falls
        # back to the default transport — the all-zero topology is
        # bit-for-bit topology=None.
        if topo is not None:
            cost = topo.cost(v, i, take)
        elif plan.delay > 0.0:
            cost = plan.delay
        else:
            cost = 0.0
        if cost > 0.0:
            start_tx = now
            if topo is not None and topo.contention > 0.0:
                # Per-directed-link serialization: a started transfer holds
                # the link for cost·contention seconds; later transfers on
                # the same link queue behind it.
                key = (v, i)
                start_tx = max(now, link_busy.get(key, 0.0))
                link_busy[key] = start_tx + cost * topo.contention
            arrive = start_tx + cost
        else:
            arrive = now + cfg.steal_latency + cfg.steal_per_task * take
        if nf is not None:
            # Transfer leg (victim → thief): the loot is claimed — it has
            # LEFT the victim's queue — and now rides a lossy link.
            arrive += nf.extra_delay(v, i, now)
            pd = nf.drop_prob(v, i, now)
            if pd > 0.0 and float(nf_rng.random()) < pd:
                if nf.hardened:
                    # Leased two-phase transfer: the drop expires the lease
                    # lease_timeout later and the tasks return to the victim
                    # (or a live survivor) — exactly-once delivery at the
                    # price of one lease_timeout of queueing latency.
                    stats["lease"] += 1
                    in_transit[i] += take
                    push_event(
                        now + nf.lease_timeout, "lease", i, (v, stamps)
                    )
                else:
                    # Ablation (hardened=False): fire-and-forget transfer —
                    # the loot is gone.  Counted so the run can terminate
                    # and the benchmark can report the damage.
                    stats["lost"] += take
                pol.on_steal_result(view, plan, take, depth(v))
                return True
        in_transit[i] += take
        push_event(arrive, "receive", i, stamps)
        stats["steals"] += 1
        stats["moved"] += take
        steal_log.append((now, i, v, take))
        pol.on_steal_result(view, plan, take, depth(v))
        return True

    def land(node: int, stamps, now: float) -> None:
        """Queue stamps head-side on ``node`` and wake it if idle."""
        queues[node].extendleft(stamps)
        for s in stamps:
            qcls[node, task_cls[s]] += 1.0
        if uses_ring:
            publish(node, now)
        if idle_since[node] >= 0.0:
            idle_since[node] = -1.0
            start_task(node, now)

    # ---- Autoscale plane (cfg.autoscale): reserve slots res0.. activate in
    # order and deactivate LIFO, reusing the join/retire machinery so the
    # policy sees ordinary membership churn.  Holt's level+trend state
    # drives the predictive mode; neither mode touches scheduler rng.
    res0 = p0 + len(joins)  # == p0 whenever scaler is set (joins rejected)
    res_active: list[int] = []
    scale_state = {"level": 0.0, "trend": 0.0, "prev": 0, "init": False,
                   "idle": 0}
    if scaler is not None and total_tasks:
        mean_task_s = cfg.task_cost * float(np.mean(costs[task_cls]))
    else:
        mean_task_s = cfg.task_cost

    def scale_out(i: int, now: float, pending: int) -> None:
        nonlocal p, radius
        if i >= p:
            p = i + 1
        alive_sim[i] = True
        born[i] = now
        own_report[i] = now
        radius = _radius_for(p)
        if uses_ring:
            hist[i].append(now, 0.0, float("nan"))
        res_active.append(i)
        scale_log.append((now, "out", i, pending))
        pol.on_worker_join(i, now)
        start_task(i, now)

    def scale_in(now: float, pending: int) -> None:
        i = res_active.pop()
        alive_sim[i] = False
        stamps = list(queues[i])
        queues[i].clear()
        qcls[i, :] = 0.0
        if uses_ring:
            publish(i, now)
        for s in stamps:
            land(route(prefer_central=False), [s], now)
        scale_log.append((now, "in", i, pending))
        pol.on_worker_death(i, now)

    # Boot: all initial nodes start their first task at t=0.  Open-arrival
    # tasks enter through "arrive" events whose landing node is resolved at
    # ARRIVAL time (policy central queue, else live round-robin) — the ring
    # may have grown or shrunk since the trace was generated.  Membership
    # events are scheduled alongside.
    if open_mode:
        push_arrival()
    if scaler is not None:
        push_event(scaler.interval, "scale", -1)
    for k, (t_join, _speed) in enumerate(joins):
        push_event(float(t_join), "join", p0 + k)
    for t_ret, node in cfg.retires:
        if not 0 <= node < pmax:
            raise ValueError(f"retire target {node} outside the ring 0..{pmax - 1}")
        if node >= p0 and t_ret < joins[node - p0][0]:
            # Would hit the not-yet-joined node's tombstone guard and be
            # silently dropped — surface the mis-ordered churn script.
            raise ValueError(
                f"retire of node {node} at t={t_ret} precedes its join "
                f"at t={joins[node - p0][0]}"
            )
        push_event(float(t_ret), "retire", int(node))
    pol.on_start([depth(i) for i in range(p)], 0.0)
    for i in range(p0):
        start_task(i, 0.0)

    makespan = 0.0
    # lost > 0 is only reachable under the hardened=False ablation: those
    # tasks will never finish, so the run quiesces at done + lost == total.
    while heap and stats["done"] + stats["lost"] < total_tasks:
        now, _, kind, i, payload = heapq.heappop(heap)
        if kind == "finish":
            executed[i] += 1
            stats["done"] += 1
            runtime_sum[i] += pending_dur[i]
            task = pending_task[i]
            if has_classes:
                # Owner-side EWMA t̂[c] on completion — same update rule as
                # WorkerPool._observe_class_time, in virtual time.
                c = int(task_cls[task])
                prev = class_t[i, c]
                if prev != prev:  # first observation of this class
                    class_t[i, c] = pending_dur[i]
                else:
                    class_t[i, c] = (
                        cfg.ewma_alpha * pending_dur[i]
                        + (1.0 - cfg.ewma_alpha) * prev
                    )
            if open_mode:
                lat_v = now - float(task_arrival[task])
                latencies.append(lat_v)
                if slo_tele:
                    s = int(task_slo[task])
                    slo_lat[SLO_NAMES[s]].append(lat_v)
                    if lat_v > float(budgets[s]):
                        slo_viol[SLO_NAMES[s]] += 1
            makespan = max(makespan, now)
            if detect:
                # Owner-side limp detection on the completed duration (the
                # only thing the owner can actually observe — DESIGN.md
                # §Straggler plane caveat), normalised to average-class
                # terms so heavy tasks don't read as a slowdown.
                st = limp_states[i]
                st.observe(
                    normalize_duration(
                        pending_dur[i], int(task_cls[task]),
                        class_t[i] if has_classes else None,
                    )
                )
                flagged = st.evaluate(
                    peer_ref=(
                        _peer_ref(i, now)
                        if st.samples < cfg.limp.min_samples
                        else float("nan")
                    )
                )
                if flagged != bool(limping[i]):
                    limping[i] = flagged
                    limp_events.append((now, i, flagged))
            if uses_ring:
                # Update own info + history (Alg. 1 line 11 + communicate).
                cur_t[i] = runtime_sum[i] / executed[i]
                publish(i, now)
                own_report[i] = now  # owner-driven heartbeat (wedge detector)
            # Smart stealing right after finishing a task (preemptive);
            # a node retired mid-task completes it, then leaves the loop.
            boundary(i, now)
            start_task(i, now)
        elif kind == "arrive":
            push_arrival()  # stream the next trace entry onto the heap
            arrived += 1
            target = route()
            if target < 0:
                # Unlike the threaded plane (which raises PoolCollapsed at
                # submit), silently parking the stamp would truncate the
                # latency/task counts the caller is measuring — fail loud.
                raise RuntimeError(
                    f"arrival at t={now:.3f} but every node has retired; "
                    "fix the churn script (cfg.retires/joins)"
                )
            land(target, [payload], now)
        elif kind == "receive":
            in_transit[i] -= len(payload)
            if not alive_sim[i]:
                # Loot landed on a node that retired while it was in
                # transit: forward it to a live member immediately.
                tgt = route(prefer_central=False)
                if tgt < 0:
                    raise RuntimeError(
                        f"steal loot arrived at t={now:.3f} but every node "
                        "has retired; fix the churn script"
                    )
                land(tgt, payload, now)
                continue
            land(i, payload, now)
        elif kind == "lease":
            # Lease expiry: the dropped transfer's tasks return to their
            # victim (or a live survivor if it retired meanwhile) — the
            # second phase of the leased move, closing the exactly-once
            # guarantee.  The thief learns of the loss HERE (it waited out
            # the lease), so the health failure is recorded at expiry time.
            v, stamps = payload
            in_transit[i] -= len(stamps)
            health.record(i, v, False, now)
            tgt = v if alive_sim[v] else route(prefer_central=False)
            if tgt < 0:
                raise RuntimeError(
                    f"lease expired at t={now:.3f} but every node has "
                    "retired; fix the churn script"
                )
            land(tgt, stamps, now)
        elif kind == "retry":
            if not alive_sim[i]:
                continue  # tombstoned while idle: drop the poll loop
            if queues[i] or idle_since[i] < 0.0:
                continue  # no longer idle
            if stats["done"] + stats["lost"] >= total_tasks:
                continue
            if uses_ring:
                # An idle poll IS a heartbeat: the threaded idle loop keeps
                # reaching boundaries and bumping its own ring row, so only
                # a worker stuck INSIDE a task goes silent (the wedge).
                own_report[i] = now
            if not boundary(i, now):
                # mild exponential backoff so long idle tails stay cheap
                delay = cfg.retry_interval * (1.3 ** min(payload, 12))
                push_event(now + delay, "retry", i, payload + 1)
            # on success the stolen tasks arrive via a "receive" event
        elif kind == "scale":
            live = int(alive_sim.sum())
            pending = arrived - stats["done"] - stats["lost"]
            if scaler.mode == "threshold":
                # PR-3 serve-plane port: one action per tick on the
                # instantaneous backlog, scale-in after a full idle streak.
                if (
                    pending > scaler.high_pending_per_replica * max(live, 1)
                    and len(res_active) < len(reserve)
                ):
                    scale_out(res0 + len(res_active), now, pending)
                    scale_state["idle"] = 0
                elif pending == 0:
                    scale_state["idle"] += 1
                    if (
                        scale_state["idle"] >= scaler.idle_ticks_to_retire
                        and res_active
                    ):
                        scale_in(now, pending)
                        scale_state["idle"] = 0
                else:
                    scale_state["idle"] = 0
            else:
                # Predictive: Holt's level+trend on the observed arrival
                # rate, capacity provisioned against the HORIZON forecast —
                # reserves come up before the backlog a threshold scaler
                # waits for ever forms.
                inst = (arrived - scale_state["prev"]) / scaler.interval
                scale_state["prev"] = arrived
                if not scale_state["init"]:
                    scale_state["init"] = True
                    scale_state["level"] = inst
                else:
                    lvl_prev = scale_state["level"]
                    a = scaler.rate_alpha
                    scale_state["level"] = a * inst + (1.0 - a) * lvl_prev
                    b = scaler.trend_beta
                    scale_state["trend"] = (
                        b * (scale_state["level"] - lvl_prev)
                        + (1.0 - b) * scale_state["trend"]
                    )
                lam = max(
                    scale_state["level"]
                    + scale_state["trend"] * scaler.horizon,
                    0.0,
                )
                need = lam / scaler.target_util  # tasks/s of capacity wanted
                cap = sum(
                    float(speeds[j]) / mean_task_s
                    for j in range(p0)
                    if alive_sim[j]
                )
                want = 0
                for r in range(len(reserve)):
                    if cap >= need:
                        break
                    cap += float(speeds[res0 + r]) / mean_task_s
                    want += 1
                while len(res_active) < want:
                    scale_out(res0 + len(res_active), now, pending)
                if len(res_active) > want and pending <= live:
                    # Recede one per tick, and only once the backlog is
                    # small — draining a reserve re-sprays its queue.
                    scale_in(now, pending)
            if arrived < total_tasks or pending > 0:
                push_event(now + scaler.interval, "scale", -1)
        elif kind == "join":
            # Scale-out: node i materialises NOW — empty queue, no history,
            # preemptive estimates date from `born[i]`, and the policy grows
            # any member-count state before the joiner's first boundary.
            p = i + 1
            alive_sim[i] = True
            born[i] = now
            own_report[i] = now  # heartbeat baseline starts at the join
            radius = _radius_for(p)
            if uses_ring:
                hist[i].append(now, 0.0, float("nan"))
            pol.on_worker_join(i, now)
            start_task(i, now)  # empty queue -> the retry/steal loop
        elif kind == "retire":
            if not alive_sim[i]:
                continue  # already tombstoned (double retire / dead)
            alive_sim[i] = False
            # Graceful drain: re-spray the queued stamps over live members
            # (the threaded plane's retire_worker(drain=True) semantics).
            stamps = list(queues[i])
            queues[i].clear()
            qcls[i, :] = 0.0
            if uses_ring:
                publish(i, now)
            if stamps and not alive_sim[:p].any():
                raise RuntimeError(
                    f"retiring the last live node at t={now:.3f} with "
                    f"{len(stamps)} task(s) queued would silently drop "
                    "them; fix the churn script"
                )
            for s in stamps:
                land(route(prefer_central=False), [s], now)
            pol.on_worker_death(i, now)

    pol.termination(makespan)
    return SimResult(
        makespan=makespan,
        per_node_tasks=[int(x) for x in executed],
        per_node_busy=[float(b) for b in busy],
        steals=stats["steals"],
        failed_steals=stats["failed"],
        moved_tasks=stats["moved"],
        records=records,
        latencies=latencies,
        limp_events=limp_events,
        steal_log=steal_log,
        boundaries=stats["boundaries"],
        net_failed=stats["net_failed"],
        lease_expired=stats["lease"],
        lost_tasks=stats["lost"],
        slo_latencies=slo_lat,
        slo_violations=slo_viol,
        scale_log=scale_log,
    )
