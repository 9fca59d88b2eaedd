"""Pluggable scheduling policies — one worker-loop substrate, many schedulers.

The paper's contribution is a *policy* (adaptive victim selection + Eq. 4-7
steal sizing over the §2.1 info ring), not the plumbing around it.  This
module separates the two: a ``SchedPolicy`` decides *whether, whom and how
much to steal* at every task boundary, while the execution substrates — the
threaded ``repro.core.a2ws.WorkerPool`` (real time) and the discrete-event
``repro.core.simulator`` (virtual time) — own deques, clocks, termination and
telemetry.  The SAME policy objects drive both planes, so every policy is
measurable under closed batches and open arrivals, threaded and simulated,
with identical semantics (DESIGN.md §Policy layer).

Hook contract
-------------
``on_boundary(view) -> StealPlan | None`` is called at every task boundary
and idle tick with a :class:`PolicyView` of what the worker may legally know:
its info-ring estimates (ring policies), one-sided ground-truth depth reads
(``view.depth`` — an RMA head/tail snapshot costs one atomic in the paper's
protocol, so classical random stealing and token counts may use it), the
plane clock and the worker's rng.  Returning a plan asks the substrate to
execute the Fig. 3b steal; the substrate then reports the outcome through
``on_steal_result`` (the get-accumulate snapshot is knowledge the policy may
fold into its own state — Table 1 rows 2-3).

Policies must be thread-safe across workers in the threaded plane: any
cross-worker state (CTWS token, LW leader gate) takes an internal lock.
Policies must NOT keep per-plane state keyed on wall time — ``view.now`` is
the only clock, so the same object works under both real and virtual time.

Policies never touch task payloads.  Both substrates carry first-class
:class:`repro.core.deque.Task` records (or, in the simulator, the same
fields column-wise), but everything a policy sees is already aggregated
into the view — queue depths, per-class counts, work-second estimates.
SLO ordering (DESIGN.md §SLO serving) lives entirely at the OWNER end of
the deque: plans, victim selection and loot sizing are SLO-blind, which is
what keeps the no-SLO degenerate configuration bit-for-bit identical and
lets thief-end steals drain batch work preferentially with no policy
change.

Implementations
---------------
* :class:`A2WSPolicy`   — the paper: Eq. 5 steal rate over the radius-R info
  ring, §2.2.2 victim selection, γ-rounding, probe steals under open arrivals.
* :class:`CTWSPolicy`   — Assis et al. 2019: one token circulates the ring
  carrying the global count vector; only the holder steals (half of the most
  loaded victim), hop cost grows with P.
* :class:`LWPolicy`     — leader–workers: worker 0 co-hosts the central queue
  (its deque); everyone else requests one task at a time through a serialized
  leader gate (service time + request RTT); worker 0 runs slower by
  ``leader_overhead`` (the co-located distributor thread).
* :class:`RandomWSPolicy` — classical receiver-initiated random stealing
  (uniform victim, steal-half), the baseline of arXiv:2211.00838 /
  arXiv:1911.06714.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .info_ring import CellDigest, CellMap, DigestBoard
from .steal import plan_steal

__all__ = [
    "StealPlan",
    "PolicyView",
    "SchedPolicy",
    "A2WSPolicy",
    "HierarchicalA2WSPolicy",
    "CTWSPolicy",
    "LWPolicy",
    "RandomWSPolicy",
    "POLICIES",
    "make_policy",
]


@dataclass(frozen=True)
class StealPlan:
    """A resolved transfer request: take ``amount`` tasks from ``victim``.

    ``delay``: dispatch latency in seconds charged before the loot lands on
    the thief's deque (LW's leader round-trip).  0.0 means "use the plane's
    default transport cost" (none in the threaded plane, ``steal_latency`` in
    the simulator).

    ``work``: loot target in equivalent reference-class tasks (work-weighted
    mode, DESIGN.md §Work-weighted stealing) — a weighted substrate then
    executes the steal greedily by work, ``amount`` acting as the count
    estimate.  0.0 = count mode: take exactly ``amount`` tasks.
    """

    victim: int
    amount: int
    criterion: str = ""
    delay: float = 0.0
    work: float = 0.0


@dataclass
class PolicyView:
    """What one worker may legally know at a task boundary.

    Built by the substrate, consumed by the policy.  Ring estimates
    (``n_view``/``t_view``/``queued``) are the plane's *information model* —
    delayed, radius-limited, preemptively extrapolated — and are ``None`` for
    policies that declared ``uses_ring = False``.  ``depth``/``alive`` are
    one-sided ground-truth reads (one RMA atomic each in the paper's
    protocol).  ``rng`` is the plane's generator (per-worker when threaded,
    global when simulated) so decision sampling stays reproducible per plane.
    """

    worker: int
    now: float
    #: the worker's own deque is EMPTY — same strict meaning in both planes,
    #: so strict-idle policies (LW requests, random/probe steals) behave
    #: identically threaded and simulated
    idle: bool
    ran_any: bool
    open_arrival: bool
    radius: int
    num_workers: int
    rng: np.random.Generator
    window: list[int]
    depth: Callable[[int], int]
    alive: Callable[[int], bool]
    pending: Callable[[], int]
    n_view: np.ndarray | None = None
    t_view: np.ndarray | None = None
    queued: np.ndarray | None = None
    #: work-weighted overlay (DESIGN.md §Work-weighted stealing): when the
    #: substrate runs with cost classes, ``n_view``/``queued`` are measured
    #: in equivalent reference-class tasks, ``unit[j]`` is the mean work per
    #: queued task at j and ``qtasks[j]`` the actual task-count estimate
    #: (γ-rounding integrality + the Fig. 3b clamp).  None = count mode —
    #: the degenerate single-class case, bit-for-bit the old behaviour.
    unit: np.ndarray | None = None
    qtasks: np.ndarray | None = None
    #: pre-overlay n estimates in TASK COUNTS (weighted mode only) — the
    #: info board's n field is count-denominated, so Fig. 3b reconciliation
    #: must derive its executed estimate from these, never from the
    #: work-repriced ``n_view``
    ntasks: np.ndarray | None = None
    #: per-class relative costs ``rel[c]`` behind the overlay (weighted mode
    #: only) — the substrate prices individual loot with it when executing a
    #: plan greedily by work
    rel: np.ndarray | None = None
    #: delayed limp-flag plane (DESIGN.md §Straggler plane): ``limp[j]`` is
    #: True when worker j has FLAGGED ITSELF as limping (owner-side detector)
    #: and the flag has propagated to this worker's view — same delay model
    #: as the (n, t) cells it rides with.  None = detection disabled (the
    #: count-based ablation) — every policy then behaves bit-for-bit as
    #: before this plane existed.
    limp: np.ndarray | None = None
    #: tasks already stolen/granted but still in transit to THIS worker —
    #: nonzero only under the simulator (threaded transfers are synchronous);
    #: one-request-at-a-time policies gate on it to avoid duplicate requests
    inflight: Callable[[], int] = lambda: 0
    #: the plane's "(nearly) idle" signal for the A2WS tail rule
    #: (``plan_steal(idle=...)``): the threaded plane reports empty-deque,
    #: the simulator reports depth<=1 (at a finish event the next pop is
    #: imminent).  Plane-calibrated by design — A2WS's own semantics predate
    #: the policy layer and are preserved exactly.  None = same as ``idle``.
    near_idle: bool | None = None
    #: hierarchy scoping (DESIGN.md §Hierarchy): when the substrate scopes
    #: this view to one CELL, ``members[local_slot]`` is the GLOBAL worker id
    #: behind each local slot (``-1`` = migration hole) and every other field
    #: — ``worker``, ``radius``, ``num_workers``, ``window``, the ring arrays,
    #: the ``depth``/``alive`` wrappers — speaks LOCAL slot indices.  The
    #: policy must translate a plan's victim back to a global id before
    #: returning it.  None = an unscoped flat view (global ids throughout).
    members: np.ndarray | None = None
    #: per-class queue-count rows behind the weighted overlay (weighted mode
    #: only) — the leader's cell digest aggregates its per-class mix from it
    nc_view: np.ndarray | None = None
    #: network pricing (DESIGN.md §Topology plane): ``transfer_cost(j,
    #: ntasks)`` is the seconds it takes to move ``ntasks`` tasks from
    #: worker ``j`` to THIS worker.  ``j`` speaks the view's index space —
    #: LOCAL slots when the view is cell-scoped (the substrate's closure
    #: translates through ``members``).  None = no network model — every
    #: policy then behaves bit-for-bit as before this plane existed.
    transfer_cost: Callable[[int, int], float] | None = None
    #: link health (DESIGN.md §Fault fabric): ``link_health(j)`` ∈ [0, 1] is
    #: the victim-weight multiplier for stealing from ``j`` over the current
    #: fabric — 0.0 across an active partition or a backed-off flaky link,
    #: the per-link success EWMA (floor-clamped) otherwise.  ``j`` speaks the
    #: view's index space, like ``transfer_cost``.  None = no fault plane —
    #: every policy then behaves bit-for-bit as before this plane existed;
    #: an all-1.0 hook is equally bit-for-bit (the multiply is skipped).
    link_health: Callable[[int], float] | None = None


class SchedPolicy:
    """Base scheduling policy: hook defaults shared by all implementations."""

    name: str = "base"
    #: substrate builds the RingInfo board / delayed-view histories iff True
    uses_ring: bool = False
    #: open-arrival ``submit()`` routes here when set (LW's central queue);
    #: None = the substrate's default round-robin spray
    central: int | None = None
    #: hierarchy topology (DESIGN.md §Hierarchy): a :class:`CellMap` when the
    #: policy wants per-cell scoping — the substrate then builds one sub-board
    #: per cell and hands the policy CELL-scoped views (``view.members``
    #: non-None).  None = flat: one board, global views, exactly as before.
    cells: CellMap | None = None

    # ------------------------------------------------------------- lifecycle
    def partition(self, tasks: Sequence, num_workers: int) -> list[list]:
        """Initial task placement (§2.2.1 static block split by default)."""
        from .a2ws import partition_tasks

        return partition_tasks(tasks, num_workers)

    def on_start(self, depths: Sequence[int], now: float) -> None:
        """Substrate booted: initial per-worker queue depths."""

    def termination(self, now: float) -> None:
        """Quiescence reached: release any policy-held state (token waits,
        leader gates).  Purely a notification — the substrate's counters
        decide termination, the policy cannot veto it."""

    def bind_board(self, board) -> None:
        """The threaded substrate hands over its information board (a
        :class:`~repro.core.info_ring.CellBoard` when ``cells`` is set) so
        hierarchy policies can drive board-side membership changes (member
        migration).  The simulator never calls this — it has no board, so
        migrations there touch only the :class:`CellMap`."""

    def bind_topology(self, topology) -> None:
        """The substrate hands over its :class:`~repro.core.topology.Topology`
        when one is configured (DESIGN.md §Topology plane).  Per-boundary
        pricing flows through ``view.transfer_cost`` regardless; this hook
        exists for policy state that prices GLOBAL worker pairs outside any
        scoped view — the hierarchical leader balancer.  Default: ignore."""

    # -------------------------------------------------------------- stealing
    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        raise NotImplementedError

    def on_steal_result(
        self, view: PolicyView, plan: StealPlan, got: int, left: int
    ) -> None:
        """Outcome of an executed plan: ``got`` tasks transferred, ``left``
        tasks observed remaining on the victim (get-accumulate snapshot)."""

    # ---------------------------------------------------------------- faults
    def on_worker_death(self, worker: int, now: float) -> None:
        """A worker tombstoned itself (its re-queued tasks stay stealable).
        Graceful retirement (``WorkerPool.retire_worker``) reports through
        the same hook — from the policy's perspective a drained leaver and a
        crashed member differ only in who rescued the queued tasks."""

    # ------------------------------------------------------------- elasticity
    def on_worker_join(self, worker: int, now: float) -> None:
        """A worker joined the LIVE pool (elastic scale-out, DESIGN.md
        §Elasticity).  ``worker`` is its ring position — either a brand-new
        index one past the previous ring size, or a previously tombstoned
        slot being replaced.  Called by both substrates BEFORE the joiner
        takes its first boundary, so any policy state sized on the worker
        count must be grown here."""

    # --------------------------------------------------------------- costing
    def task_multiplier(self, worker: int) -> float:
        """Execution-time inflation for ``worker`` (LW's co-located leader
        slows worker 0).  1.0 = run at native speed."""
        return 1.0


class A2WSPolicy(SchedPolicy):
    """The paper's adaptive smart stealing (§2.2) over the §2.1 info ring.

    Decision state lives entirely in the information plane the substrate
    provides (``n_view``/``t_view``/``queued``), so the object itself is
    stateless and trivially thread-safe.  ``probe``: under open arrivals an
    idle thief whose view went stale fires one speculative single-task steal
    per idle tick (DESIGN.md §Open-arrival); the get-accumulate doubles as a
    ground-truth depth read either way.

    Work-weighted when the substrate provides the overlay (``view.unit`` /
    ``view.qtasks`` non-None): Eq. 5, victim selection and γ-rounding then
    price queues in estimated work-seconds rather than task counts
    (DESIGN.md §Work-weighted stealing).  CTWS/LW/random deliberately stay
    count-based — they are the paper's baselines, and none of them consults
    the information ring the class estimates travel on.
    """

    name = "a2ws"
    uses_ring = True

    def __init__(self, probe: bool = True) -> None:
        self.probe = probe

    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        near_idle = view.near_idle if view.near_idle is not None else view.idle
        if not near_idle and not view.ran_any:
            # Preemptive stealing starts at the first completed task
            # (Alg. 1 lines 3-9 gate); idle workers always try.
            return None
        if view.limp is not None and view.limp[view.worker]:
            # A flagged-limping worker never INITIATES steals: its collapsed
            # published t already blocks the loaded-victim tail rule, but
            # idle thieves are exempt from that rule (§2.1 relay) and the
            # probe path ignores t entirely — loot it pulled would execute
            # at the collapsed speed, the exact inversion of what the
            # re-pricing is draining.  Stolen-FROM it stays fully legal.
            return None
        decision = plan_steal(
            view.rng, view.worker, view.n_view, view.t_view, view.queued,
            view.radius, idle=near_idle, open_arrival=view.open_arrival,
            unit=view.unit, qtasks=view.qtasks,
            transfer_cost=view.transfer_cost,
            link_health=view.link_health,
        )
        if decision is None:
            return self._probe(view)
        # Topology pricing (DESIGN.md §Topology plane): the plan's ``delay``
        # carries the transfer cost of the whole batch — ONE priced transfer
        # of k tasks.  The threaded substrate clock-paces it, the simulator
        # lands the loot that many virtual seconds later (overlapped with
        # thief compute).  A free link leaves delay at 0.0, which both
        # planes read as "use the default transport cost".
        delay = 0.0
        if view.transfer_cost is not None:
            delay = max(
                float(view.transfer_cost(decision.victim, decision.amount)),
                0.0,
            )
        return StealPlan(
            decision.victim, decision.amount, decision.criterion,
            delay=delay, work=decision.work,
        )

    def on_worker_join(self, worker: int, now: float) -> None:
        """Nothing to grow: A2WS decision state lives in the information
        plane, and the substrate already recomputed the radius window and
        remapped the ring (``RingInfo.grow``).  The joiner's cells are NaN
        everywhere, so thieves price it by the §2.2.1 preemptive wall-time
        estimate until its first report propagates — exactly like boot."""

    def _probe(self, view: PolicyView) -> StealPlan | None:
        if not (self.probe and view.open_arrival):
            return None
        if view.depth(view.worker) > 0 or view.inflight() > 0:
            return None
        if view.pending() == 0:
            # Nothing queued or in flight anywhere — probing would only
            # churn atomics while the pool sits quiescent between waves.
            return None
        candidates = [
            j for j in view.window if j != view.worker and view.alive(j)
        ]
        if not candidates:
            return None
        if view.limp is not None:
            # Victim of choice: a limping peer's backlog is the worst-priced
            # work in the window — strip it first.  (The probe's uniform
            # draw is otherwise blind to t, so without this preference the
            # limper is probed no more often than a healthy node.)
            limping = [j for j in candidates if view.limp[j]]
            if limping:
                candidates = limping
        health = view.link_health
        hw = None
        if health is not None:
            # Link-health gating (DESIGN.md §Fault fabric): a probe over a
            # cut or backed-off link is a guaranteed miss — drop factor-0
            # candidates outright, bias the draw by the health EWMA of the
            # rest.  All-healthy factors (1.0) leave ``hw`` unset so the
            # draw below stays bit-for-bit the fault-free one.
            hf = [min(max(float(health(j)), 0.0), 1.0) for j in candidates]
            if any(f < 1.0 for f in hf):
                live = [(j, f) for j, f in zip(candidates, hf) if f > 0.0]
                if not live:
                    return None
                candidates = [j for j, _ in live]
                hw = np.array([f for _, f in live])
        tcost = view.transfer_cost
        costs = None
        if tcost is not None:
            costs = [max(float(tcost(j, 1)), 0.0) for j in candidates]
            if not any(c > 0.0 for c in costs):
                costs = None
        if costs is not None or hw is not None:
            # Distance/health-biased probe draw: a probe is speculative, so
            # spend it where the (single-task) transfer is cheap and the
            # link answers.  The all-zero-cost all-healthy case keeps the
            # unweighted rng.choice call — numpy's weighted draw consumes
            # the stream differently, and the identity model must stay
            # bit-for-bit unpriced.
            w = np.ones(len(candidates))
            if costs is not None:
                w *= np.array([1.0 / (1.0 + c) for c in costs])
            if hw is not None:
                w *= hw
            victim = int(view.rng.choice(candidates, p=w / w.sum()))
            delay = 0.0
            if costs is not None:
                delay = costs[candidates.index(victim)]
            return StealPlan(victim, 1, "probe", delay=delay)
        return StealPlan(int(view.rng.choice(candidates)), 1, "probe")


class HierarchicalA2WSPolicy(SchedPolicy):
    """Two-level A2WS (DESIGN.md §Hierarchy): K cells of ~ρ members, each
    running ordinary intra-cell A2WS on its own sub-board, plus a leader-level
    balancer over a K-wide digest plane.

    The substrate sees ``cells`` non-None and scopes every view to the
    worker's cell (``view.members`` carries the local→global mapping), so the
    per-boundary cost is O(ρ), not O(P).  Inside a cell the delegate
    :class:`A2WSPolicy` runs UNCHANGED — Eq. 5 radius, victim selection,
    γ-rounding, weighted overlay and limp re-pricing all scoped to ρ members.
    With ``num_cells=1`` the scoped view IS the flat view (identity mapping,
    same radius), the delegate consumes the rng identically, and the leader
    plane has no peers to balance against — K=1 is bit-for-bit the flat
    scheduler (property-tested).

    Leader plane: the first LIVE slot of each cell is its leader (leadership
    fails over automatically when that member dies).  At its own boundaries
    the leader (a) publishes a :class:`CellDigest` — aggregate queued
    work-seconds, task count, live membership, per-class mix, richest member
    — computed from its ordinary delayed intra-cell view, and (b) runs the
    balancer: when the richest peer cell's digest exceeds this cell's by more
    than ``band_hi`` × mean cell work (and this cell sits below the mean),
    the leader fires a batched inter-cell steal against that cell's richest
    member (half its queue, the get-accumulate clamp handles staleness).
    ``cooldown`` leader boundaries must pass between fires (loot needs time
    to land before re-judging), and the pressure counter resets once the gap
    falls under ``band_lo`` × mean — a hysteresis band, so digest noise
    cannot make leaders ping-pong loot.  When the gap persists for
    ``patience`` consecutive fires, the leader re-homes its last live
    follower INTO the rich cell (member migration — capacity moves to the
    work when loot-moving alone cannot keep up).

    Inter-cell loot lands on the leader's deque and is redistributed by
    ordinary intra-cell stealing; cross-cell ``record_remote`` is dropped by
    the :class:`~repro.core.info_ring.CellBoard` (digests, not cells, carry
    inter-cell knowledge).
    """

    name = "ha2ws"
    uses_ring = True

    def __init__(
        self,
        num_workers: int,
        num_cells: int | None = None,
        cell_size: int | None = None,
        cell_radius: int | None = None,
        probe: bool = True,
        band_hi: float = 0.5,
        band_lo: float = 0.15,
        cooldown: int = 3,
        patience: int = 12,
    ) -> None:
        self.cells = CellMap(
            num_workers, num_cells=num_cells, cell_size=cell_size,
            radius=cell_radius,
        )
        self.inner = A2WSPolicy(probe=probe)
        self.digests = DigestBoard(self.cells.num_cells)
        self.band_hi = float(band_hi)
        self.band_lo = float(band_lo)
        self.cooldown = int(cooldown)
        self.patience = int(patience)
        k = self.cells.num_cells
        self._cool = [0] * k   # leader boundaries left before the next fire
        self._lag = [0] * k    # consecutive fires with the gap still open
        self._lock = threading.Lock()
        self._board = None     # threaded CellBoard (bind_board); None in sim
        self._topology = None  # network pricing (bind_topology); None = free
        self.xcell_steals = 0  # telemetry: inter-cell steal plans fired
        self.xcell_moved = 0   # telemetry: member migrations executed
        self.xcell_refused = 0  # telemetry: fires refused as net-negative
        self.migrations: list[tuple[float, int, int, int]] = []

    # ------------------------------------------------------------- lifecycle
    def bind_board(self, board) -> None:
        self._board = board

    def bind_topology(self, topology) -> None:
        # The balancer prices GLOBAL pairs (leader <- rich cell's top
        # worker), which no cell-scoped view.transfer_cost can express.
        self._topology = topology

    def on_start(self, depths: Sequence[int], now: float) -> None:
        with self._lock:
            self.digests.reset()
            k = self.cells.num_cells
            self._cool = [0] * k
            self._lag = [0] * k
            self.xcell_steals = 0
            self.xcell_moved = 0
            self.xcell_refused = 0
            self.migrations = []

    def on_worker_join(self, worker: int, now: float) -> None:
        # Home the joiner (smallest live cell); idempotent for a recycled
        # tombstone slot, which keeps its cell.  The substrate grows the
        # cell's sub-board AFTER this hook returns.
        self.cells.assign(worker)

    # -------------------------------------------------------------- stealing
    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        members = view.members
        if members is None:
            # Unscoped substrate (defensive): degrade to flat A2WS.
            return self.inner.on_boundary(view)
        cell = self.cells.cell_of(int(members[view.worker]))
        if self._leader_slot(view, members) == view.worker:
            # Leader duties consume NO rng — K=1 stays bit-for-bit flat.
            self._publish(view, cell, members)
            plan = self._balance(view, cell)
            if plan is not None:
                return plan
        plan = self.inner.on_boundary(view)
        if plan is None:
            return None
        victim = int(members[plan.victim])
        if victim < 0:
            return None  # raced a migration hole: skip this boundary
        return StealPlan(
            victim, plan.amount, plan.criterion, plan.delay, plan.work
        )

    @staticmethod
    def _leader_slot(view: PolicyView, members: np.ndarray) -> int:
        for jl in range(len(members)):
            if members[jl] >= 0 and view.alive(jl):
                return jl
        return -1

    def _publish(
        self, view: PolicyView, cell: int, members: np.ndarray
    ) -> None:
        m = len(members)
        n, t, q = view.n_view[:m], view.t_view[:m], view.queued[:m]
        live = np.fromiter(
            (members[jl] >= 0 and view.alive(jl) for jl in range(m)),
            dtype=bool, count=m,
        )
        # Tombstone/limp sentinels (t >= ~1e12) would explode the aggregate;
        # price unknown/dead cells at the median known rate instead.
        tt = np.where(np.isfinite(t) & (t < 1e11), t, np.nan)
        known = np.isfinite(tt)
        med = float(np.nanmedian(tt)) if known.any() else 1.0
        tt = np.where(known, tt, med)
        qq = np.where(live, np.maximum(q, 0.0), 0.0)
        work_j = qq * tt
        qt = view.qtasks[:m] if view.qtasks is not None else q
        tasks = float(np.where(live, np.maximum(qt, 0.0), 0.0).sum())
        top_worker, top_queued, top_work = -1, 0, 0.0
        cand = np.nonzero(live & (np.floor(qt) >= 1.0))[0]
        if cand.size:
            jl = int(cand[np.argmax(work_j[cand])])
            top_worker = int(members[jl])
            top_queued = int(qt[jl])
            top_work = float(qq[jl])
        mix = None
        if view.nc_view is not None:
            mix = view.nc_view[:m][live].sum(axis=0)
        self.digests.publish(CellDigest(
            cell, view.now, float(work_j.sum()), tasks, int(live.sum()),
            top_worker, top_queued, top_work, mix,
            leader=int(members[view.worker]),
        ))

    @staticmethod
    def _aged_work(d: CellDigest, now: float) -> float:
        """A digest's work estimate decayed to ``now``: each live member
        retires ~one second of (its own re-priced) work per second, so a
        stale digest is discounted by ``live × age`` — without this, a peer
        that published EARLIER always looks richer than a fresh self-digest
        and balanced pools ping-pong loot at boot."""
        return max(d.work - max(now - d.time, 0.0) * d.live, 0.0)

    def _balance(self, view: PolicyView, cell: int) -> StealPlan | None:
        own = self.digests.get(cell)
        peers = self.digests.peers(cell)
        if own is None or not peers:
            return None  # K=1, or no peer has published yet
        aged = [self._aged_work(d, view.now) for d in peers]
        vals = [own.work] + aged
        mean = sum(vals) / len(vals)
        if mean <= 0.0:
            return None
        ri = max(range(len(peers)), key=lambda k: aged[k])
        rich = peers[ri]
        gap = aged[ri] - own.work
        amount = max(1, rich.top_queued // 2)
        delay = 0.0
        with self._lock:
            if self._cool[cell] > 0:
                self._cool[cell] -= 1
            if gap <= self.band_lo * mean:
                self._lag[cell] = 0  # gap closed: release migration pressure
                return None
            if gap <= self.band_hi * mean or own.work >= mean:
                return None
            if rich.top_worker < 0 or rich.top_queued < 1:
                return None
            if self._topology is not None:
                # Cross-cell pricing (DESIGN.md §Topology plane): the batch
                # is net-negative when the work-seconds it moves don't beat
                # the link cost — the hysteresis band must not fire on a
                # steal the network would eat.  Refusal consumes no
                # cooldown: the band re-judges at the next leader boundary.
                delay = max(
                    float(self._topology.cost(
                        int(rich.top_worker), int(view.members[view.worker]),
                        amount,
                    )),
                    0.0,
                )
                if delay > 0.0:
                    per = rich.work / rich.tasks if rich.tasks >= 1.0 else 0.0
                    moved = (
                        rich.top_work / 2.0
                        if rich.top_work > 0.0
                        else amount * per
                    )
                    if not (moved > delay):
                        self.xcell_refused += 1
                        return None
            if self._cool[cell] > 0:
                return None
            self._cool[cell] = self.cooldown
            self._lag[cell] += 1
            self.xcell_steals += 1
            if self._lag[cell] >= self.patience:
                self._lag[cell] = 0
                mover = self._pick_migrant(view)
                if mover >= 0:
                    if self._board is not None:
                        self._board.migrate(mover, rich.cell)
                    else:
                        self.cells.migrate(mover, rich.cell)
                    self.xcell_moved += 1
                    self.migrations.append((view.now, mover, cell, rich.cell))
        work = rich.top_work / 2.0 if view.unit is not None else 0.0
        return StealPlan(
            rich.top_worker, amount, "x-cell", delay=delay, work=work
        )

    def _pick_migrant(self, view: PolicyView) -> int:
        """Last live follower of the leader's cell (never the leader itself
        — the cell keeps its digest publisher), or -1 when the leader is
        alone."""
        members = view.members
        for jl in range(len(members) - 1, -1, -1):
            if jl == view.worker:
                continue
            if members[jl] >= 0 and view.alive(jl):
                return int(members[jl])
        return -1


class CTWSPolicy(SchedPolicy):
    """Cyclic token-based work-stealing (Assis et al., 2019).

    One token circulates the ring carrying the global task-count vector;
    only the holder may steal (race/deadlock freedom by exclusivity), it
    steals HALF the most-loaded victim's tasks, and it steals only when its
    own deque is empty.  Busy holders forward the token at task boundaries.
    ``hop_time`` models the token transfer cost (it carries a P-sized
    vector, so real deployments scale it with P): the token is usable only
    ``hop_time`` seconds after the previous holder released it — a virtual
    gate that works identically under wall and simulated time.
    """

    name = "ctws"

    def __init__(self, num_workers: int, hop_time: float = 0.0) -> None:
        self.num_workers = num_workers
        self.hop_time = hop_time
        self.counts = np.zeros(num_workers, dtype=np.int64)
        self.token_at = 0
        self.token_ready = 0.0
        self._dead: set[int] = set()
        self._lock = threading.Lock()

    def on_start(self, depths: Sequence[int], now: float) -> None:
        with self._lock:
            # Reset circulation state so the same policy object can drive a
            # fresh run (HetDPTrainer builds one runtime per optimizer step).
            self.counts[: len(depths)] = depths
            self.token_at = 0
            self.token_ready = now + self.hop_time
            self._dead.clear()

    def _advance(self, now: float) -> None:
        # Pass the token, skipping tombstoned workers (a dead holder would
        # freeze the ring forever — the liveness hole of token schemes).
        for _ in range(self.num_workers):
            self.token_at = (self.token_at + 1) % self.num_workers
            if self.token_at not in self._dead:
                break
        self.token_ready = now + self.hop_time

    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        i = view.worker
        with self._lock:
            if self.token_at != i or view.now < self.token_ready:
                return None
            my_depth = view.depth(i)
            self.counts[i] = my_depth
            # Tombstoned workers stop publishing, but their deques (holding
            # their re-queued tasks) stay readable — fold in ground truth so
            # orphaned work is rescued instead of stranded.
            for j in self._dead:
                self.counts[j] = view.depth(j)
            plan = None
            if my_depth == 0 and view.inflight() == 0:
                victim = int(np.argmax(self.counts))
                if victim != i and self.counts[victim] > 0:
                    plan = StealPlan(
                        victim, max(1, int(self.counts[victim]) // 2), "token"
                    )
            self._advance(view.now)
            return plan

    def on_steal_result(
        self, view: PolicyView, plan: StealPlan, got: int, left: int
    ) -> None:
        with self._lock:
            # The holder refreshes the vector entries it just learned
            # first-hand (the token carries them to everyone downstream).
            self.counts[plan.victim] = left
            self.counts[view.worker] = view.depth(view.worker)

    def on_worker_death(self, worker: int, now: float) -> None:
        with self._lock:
            self._dead.add(worker)
            self.counts[worker] = 0
            if self.token_at == worker:
                self._advance(now)

    def on_worker_join(self, worker: int, now: float) -> None:
        with self._lock:
            if worker >= self.num_workers:
                grown = np.zeros(worker + 1, dtype=np.int64)
                grown[: self.num_workers] = self.counts
                self.counts = grown
                self.num_workers = worker + 1
            # Un-skip: the slot re-enters the token rotation (``_advance``
            # hops over ``_dead`` members, so without this a replacement in
            # a tombstoned slot would never receive the token).
            self._dead.discard(worker)
            self.counts[worker] = 0


class LWPolicy(SchedPolicy):
    """Centralized leader–workers dynamic scheduling (paper §4 baseline).

    The central queue is worker 0's deque (the leader is co-located with
    worker 0, as in the paper): worker 0 pops it directly, every other worker
    requests ONE task at a time through the leader.  The leader is a serial
    server — each request waits for ``leader_free``, holds it for
    ``service_time`` and pays ``request_rtt`` on the wire — which reproduces
    the paper's congestion pathology as the worker count grows.  Worker 0
    additionally runs ``1 + leader_overhead`` slower (the co-located
    distributor thread steals its cycles, Fig. 5b).
    """

    name = "lw"
    central = 0

    def __init__(
        self,
        leader_overhead: float = 0.0,
        service_time: float = 0.0,
        request_rtt: float = 0.0,
    ) -> None:
        self.leader_overhead = leader_overhead
        self.service_time = service_time
        self.request_rtt = request_rtt
        self.leader_free = 0.0
        self._lock = threading.Lock()

    def partition(self, tasks: Sequence, num_workers: int) -> list[list]:
        # Everything starts on the central queue (worker 0's deque).
        out: list[list] = [[] for _ in range(num_workers)]
        out[0] = list(tasks)
        return out

    def on_start(self, depths: Sequence[int], now: float) -> None:
        with self._lock:
            self.leader_free = now  # fresh run: the leader starts idle

    def task_multiplier(self, worker: int) -> float:
        return 1.0 + self.leader_overhead if worker == 0 else 1.0

    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        i = view.worker
        if not view.idle or view.inflight() > 0:
            # One outstanding request at a time (classical on-demand
            # dispatch — a worker never queues ahead at the leader).
            return None
        # Fault recovery: a tombstoned worker's re-queued tasks sit on its
        # own (still readable) deque — reclaim them before they strand.
        for j in range(view.num_workers):
            if j != i and not view.alive(j) and view.depth(j) > 0:
                return StealPlan(j, view.depth(j), "reclaim")
        if i == 0:
            # The leader's co-located worker has direct queue access; other
            # workers only request when they have nothing to run (classical
            # on-demand dispatch).
            return None
        if view.depth(0) == 0 or not view.alive(0):
            return None
        with self._lock:
            start = max(view.now + self.request_rtt / 2.0, self.leader_free)
            self.leader_free = start + self.service_time
            grant = self.leader_free + self.request_rtt / 2.0
        return StealPlan(0, 1, "leader", delay=max(grant - view.now, 0.0))

    def on_worker_join(self, worker: int, now: float) -> None:
        """Joiners become requesters: the central queue stays on worker 0
        and the new worker's first idle boundary sends it through the same
        serialized leader gate as everyone else — no policy state to grow."""


class RandomWSPolicy(SchedPolicy):
    """Classical receiver-initiated random work-stealing: an idle thief
    probes a uniformly random victim and steals HALF its queue (the baseline
    both arXiv:2211.00838 and arXiv:1911.06714 compare against).

    No information ring: the victim's depth comes from the one-sided
    head/tail snapshot (``view.depth`` — one RMA atomic), and victims are
    drawn over the WHOLE system, not a radius window.
    """

    name = "random"

    def on_boundary(self, view: PolicyView) -> StealPlan | None:
        if not view.idle or view.inflight() > 0:
            return None
        i = view.worker
        # Any non-empty deque is fair game — including a tombstoned worker's
        # (still readable, holding its re-queued tasks).
        loaded = [
            j for j in range(view.num_workers)
            if j != i and view.depth(j) > 0
        ]
        if not loaded:
            return None
        victim = int(view.rng.choice(loaded))
        return StealPlan(victim, max(1, view.depth(victim) // 2), "random-half")

    def on_worker_join(self, worker: int, now: float) -> None:
        """The victim set grows implicitly: every boundary draws uniformly
        over ``view.num_workers``, which the substrate already bumped."""


POLICIES = ("a2ws", "ha2ws", "ctws", "lw", "random")


def make_policy(spec: str | SchedPolicy, num_workers: int, **kw) -> SchedPolicy:
    """Resolve a policy spec (name or ready instance) to a policy object.

    Keyword arguments are forwarded to the named policy's constructor
    (``hop_time`` for ctws; ``leader_overhead``/``service_time``/
    ``request_rtt`` for lw) and must be empty for an instance spec.
    """
    if isinstance(spec, SchedPolicy):
        if kw:
            raise ValueError(
                f"policy kwargs {sorted(kw)} conflict with an instance spec"
            )
        return spec
    if spec == "a2ws":
        return A2WSPolicy(**kw)
    if spec == "ha2ws":
        return HierarchicalA2WSPolicy(num_workers, **kw)
    if spec == "ctws":
        return CTWSPolicy(num_workers, **kw)
    if spec == "lw":
        return LWPolicy(**kw)
    if spec == "random":
        return RandomWSPolicy(**kw)
    raise ValueError(f"unknown policy {spec!r}; known: {', '.join(POLICIES)}")
