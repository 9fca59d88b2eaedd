"""Network-fault plane: lossy links, partitions, leases (DESIGN.md §Fault fabric).

The topology plane (PR 7) made the fabric *slow* — every steal pays a
modeled fare — but never *lossy*: each probe and each loot transfer was
assumed to arrive.  This module drops that assumption.  A
:class:`NetFaultSchedule` is a scriptable description of network faults,
injected identically into both execution planes exactly like
``SlowdownSchedule`` (the straggler plane, DESIGN.md §Straggler plane):

* :class:`LinkFault` — a timed window during which a directed link (or a
  wildcard set of links) drops each message with probability ``drop_prob``
  and/or delays it by ``extra_delay`` seconds.

* :class:`PartitionEvent` — a timed split of the worker set: every link
  crossing the cut is *down* (deterministically unreachable, not merely
  lossy) until the partition heals.

The schedule is a pure function of plane time — ``drop_prob(src, dst, t)``,
``extra_delay(src, dst, t)``, ``reachable(src, dst, t)`` — so the
discrete-event simulator evaluates it at virtual time and the threaded
pool at ``clock() - t0``, with no hidden state.

Hardening state lives in :class:`LinkHealth`: a per-(thief, victim)
success EWMA (the link analogue of PR 5's per-worker limp detector) plus
a consecutive-failure capped exponential backoff.  Victim weights are
multiplied by the health factor, a blocked link weighs 0, and the
``health_floor`` keeps flaky links sampled occasionally (the probation
canary analogue) so they can recover.

RNG discipline (DESIGN.md §Conformance): fault rolls come from a
DEDICATED generator seeded off the main seed, and every roll is gated on
``drop_prob > 0`` — an empty schedule consumes no randomness and every
health factor stays 1.0, so ``NetFaultSchedule()`` reproduces the
fault-free scheduler bit for bit, rng stream included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

__all__ = [
    "LinkFault",
    "PartitionEvent",
    "NetFaultSchedule",
    "LinkHealth",
    "parse_netfaults",
]

# Seed perturbation for the dedicated fault rng (golden-ratio constant —
# any fixed odd-ish constant works; it only has to decorrelate the fault
# stream from the scheduler stream for every base seed).
NF_SEED_SALT = 0x9E3779B9


@dataclass(frozen=True)
class LinkFault:
    """One timed lossy-link window.

    ``src``/``dst`` of ``None`` are wildcards (any sender / any
    receiver); links are DIRECTED, so a symmetric fault needs two
    entries or double wildcards.  ``drop_prob`` is the per-message drop
    probability while the window is active; ``extra_delay`` is added to
    the transport time of messages that do get through.
    """

    src: int | None = None
    dst: int | None = None
    start: float = 0.0
    duration: float = math.inf
    drop_prob: float = 0.0
    extra_delay: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob must be in [0,1], got {self.drop_prob}")
        if self.extra_delay < 0.0 or self.duration < 0.0:
            raise ValueError("extra_delay and duration must be >= 0")

    @property
    def end(self) -> float:
        return self.start + self.duration

    def matches(self, src: int, dst: int, t: float) -> bool:
        return (
            (self.src is None or self.src == src)
            and (self.dst is None or self.dst == dst)
            and self.start <= t < self.end
        )


@dataclass(frozen=True)
class PartitionEvent:
    """A timed network partition: ``side`` vs everyone else.

    While active, every directed link with exactly one endpoint in
    ``side`` is down — messages across the cut are lost with certainty
    and both components must degrade gracefully.  Links within either
    component are untouched.  The partition heals at ``start +
    duration`` and both sides reconcile (ring resync, backoff reset).
    """

    side: tuple[int, ...]
    start: float
    duration: float = math.inf
    # Cached frozenset view of ``side`` for O(1) membership.
    _side_set: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.duration < 0.0:
            raise ValueError("duration must be >= 0")
        object.__setattr__(self, "side", tuple(int(w) for w in self.side))
        object.__setattr__(self, "_side_set", frozenset(self.side))

    @property
    def end(self) -> float:
        return self.start + self.duration

    def separates(self, src: int, dst: int, t: float) -> bool:
        if not self.start <= t < self.end:
            return False
        return (src in self._side_set) != (dst in self._side_set)


@dataclass(frozen=True)
class NetFaultSchedule:
    """Scriptable network-fault plane + hardening knobs.

    An EMPTY schedule (no faults, no partitions) is the identity: it is
    property-tested bit-for-bit equal to ``netfaults=None`` in both
    planes (tests/test_netfault.py), mirroring ``SlowdownSchedule()``
    and ``Topology.uniform(0, 0)``.

    Hardening knobs (all consumed by the schedulers, not the schedule):

    * ``lease_timeout`` — a loot transfer is a LEASED two-phase move:
      the thief claims tasks under a lease; if the transfer is dropped
      (or the thief dies mid-flight), the lease expires after this many
      seconds and the tasks return to the victim.  No task is ever
      lost; the cost of an expiry is one lease_timeout of added latency
      for the leased tasks.
    * ``attempt_timeout`` — how long a threaded thief stalls on a
      request that went unanswered (the sim charges its retry path).
    * ``backoff_base`` / ``backoff_cap`` — consecutive failures on a
      (thief, victim) link block it for ``base·2^(k-1)`` seconds,
      capped.
    * ``health_alpha`` / ``health_floor`` — link-health EWMA step and
      the minimum sampling weight for an unblocked flaky link (the
      probation-canary analogue: a floored link still gets the odd
      probe, so a healed link recovers its weight).
    * ``stale_after`` — seconds of heartbeat silence over a CUT link
      before the observer treats the peer as unreachable in its own
      view row (t̂ inflation + limp flag, PR 7's staleness path).  This
      is observer-local: the peer's own side never flags it.
    * ``hardened`` — the ablation switch.  ``False`` turns leases,
      backoff and health-weighting OFF: a dropped transfer loses its
      loot (simulator counts it in ``lost``), a dropped request is just
      a failed steal.  Exists to measure what the hardening buys
      (benchmarks/netfault.py).
    """

    faults: tuple[LinkFault, ...] = ()
    partitions: tuple[PartitionEvent, ...] = ()
    lease_timeout: float = 0.25
    attempt_timeout: float = 0.01
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    health_alpha: float = 0.4
    health_floor: float = 0.05
    stale_after: float = 1.0
    hardened: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "faults", tuple(self.faults))
        object.__setattr__(self, "partitions", tuple(self.partitions))
        for name in ("lease_timeout", "attempt_timeout", "backoff_base",
                     "backoff_cap", "health_floor", "stale_after"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0")
        if not 0.0 < self.health_alpha <= 1.0:
            raise ValueError("health_alpha must be in (0,1]")

    # -- pure queries (plane-time functions) ---------------------------------

    def drop_prob(self, src: int, dst: int, t: float) -> float:
        """Per-message drop probability on src→dst at plane time t.

        Multiple overlapping faults compose complementarily (the message
        must survive every active fault): ``1 - Π(1 - p_k)``.  A self-link
        is always clean — local hand-offs never touch the network.
        """
        if src == dst:
            return 0.0
        keep = 1.0
        for f in self.faults:
            if f.drop_prob > 0.0 and f.matches(src, dst, t):
                keep *= 1.0 - f.drop_prob
        return 1.0 - keep

    def extra_delay(self, src: int, dst: int, t: float) -> float:
        """Added transport delay (seconds) on src→dst at plane time t
        (0.0 on a self-link — local hand-offs never touch the network)."""
        if src == dst:
            return 0.0
        d = 0.0
        for f in self.faults:
            if f.extra_delay > 0.0 and f.matches(src, dst, t):
                d += f.extra_delay
        return d

    def reachable(self, src: int, dst: int, t: float) -> bool:
        """False iff some active partition separates src from dst."""
        if src == dst:
            return True
        return not any(p.separates(src, dst, t) for p in self.partitions)

    def unreachable_since(self, src: int, dst: int, t: float) -> float:
        """Start time of the earliest active partition cutting src→dst.

        ``math.inf`` when the pair is reachable — so
        ``min(heartbeat, unreachable_since(...))`` is the identity on a
        healthy link (the PR-7 staleness path needs no special case).
        """
        cut = math.inf
        if src == dst:
            return cut
        for p in self.partitions:
            if p.separates(src, dst, t):
                cut = min(cut, p.start)
        return cut

    def heal_times(self) -> tuple[float, ...]:
        """Sorted finite partition-heal instants (for reconciliation)."""
        return tuple(sorted({p.end for p in self.partitions if math.isfinite(p.end)}))

    def lossy(self) -> bool:
        """True if the schedule can ever drop/delay/cut anything."""
        return bool(self.partitions) or any(
            f.drop_prob > 0.0 or f.extra_delay > 0.0 for f in self.faults
        )

    def workers(self) -> set[int]:
        """Every worker index the schedule names (for validation)."""
        out: set[int] = set()
        for f in self.faults:
            for w in (f.src, f.dst):
                if w is not None:
                    out.add(int(w))
        for p in self.partitions:
            out.update(p.side)
        return out


class LinkHealth:
    """Per-(thief, victim) link-health EWMA + capped exponential backoff.

    The link analogue of PR 5's :class:`~repro.core.limp.LimpState`: a
    success EWMA tracks how often attempts over a link come back, k
    consecutive failures block the link for ``base·2^(k-1)`` seconds
    (capped), and the health factor multiplies the victim weight so the
    scheduler organically routes around flaky links.  An unblocked link
    never weighs less than ``health_floor`` — the canary: it still gets
    sampled occasionally, and one success resets the backoff, so a
    healed link earns its weight back instead of being blacklisted.

    Thread-safety: in the threaded plane each worker ``i`` only ever
    touches its own ``(i, ·)`` rows (single writer per key under the
    GIL); the simulator is single-threaded.
    """

    def __init__(self, cfg: NetFaultSchedule) -> None:
        self.cfg = cfg
        self._ewma: dict[tuple[int, int], float] = {}
        self._fails: dict[tuple[int, int], int] = {}
        self._blocked_until: dict[tuple[int, int], float] = {}

    def record(self, i: int, j: int, ok: bool, now: float) -> None:
        """Fold one attempt outcome over link i→j observed at ``now``."""
        a = self.cfg.health_alpha
        key = (i, j)
        h = self._ewma.get(key, 1.0)
        self._ewma[key] = (1.0 - a) * h + (a if ok else 0.0)
        if ok:
            self._fails[key] = 0
            self._blocked_until.pop(key, None)
        else:
            k = self._fails.get(key, 0) + 1
            self._fails[key] = k
            hold = min(self.cfg.backoff_base * (2.0 ** (k - 1)), self.cfg.backoff_cap)
            self._blocked_until[key] = now + hold

    def blocked(self, i: int, j: int, now: float) -> bool:
        return self._blocked_until.get((i, j), -math.inf) > now

    def factor(self, i: int, j: int, now: float) -> float:
        """Victim-weight multiplier in [0, 1] for thief i stealing from j.

        0.0 while the link is backed off; otherwise the success EWMA
        clamped up to ``health_floor``.  A never-observed link is 1.0,
        so an all-healthy fabric changes no weight (bit-for-bit
        conformance with the fault-free scheduler).
        """
        if self.blocked(i, j, now):
            return 0.0
        h = self._ewma.get((i, j))
        if h is None or h >= 1.0:
            return 1.0
        return max(h, self.cfg.health_floor)

    def clear_backoff(self, i: int | None = None) -> None:
        """Drop backoff blocks (all links, or thief ``i``'s links) on heal.

        The EWMA is kept — a healed partition says the CUT is gone, not
        that the link was never flaky; the floor + one success restore
        full weight quickly if it is in fact healthy.
        """
        if i is None:
            self._blocked_until.clear()
            self._fails.clear()
            return
        for key in [k for k in self._blocked_until if k[0] == i]:
            del self._blocked_until[key]
        for key in [k for k in self._fails if k[0] == i]:
            del self._fails[key]


def _parse_side(tok: str, num_workers: int) -> tuple[int, ...]:
    k = int(tok) if tok else max(num_workers // 2, 1)
    if not 0 < k < num_workers:
        raise ValueError(
            f"partition side size {k} must be in (0, {num_workers})"
        )
    return tuple(range(k))


def parse_netfaults(
    spec: str | None, num_workers: int
) -> NetFaultSchedule | None:
    """Parse a CLI ``--net-faults`` spec into a schedule.

    Forms (combinable with ``+``), mirroring ``parse_topology``:

    - ``none`` / empty  — no fault plane (returns None)
    - ``drop:PROB``  — every link drops each steal message w.p. PROB
    - ``delay:SEC``  — every message pays SEC extra transport seconds
    - ``partition:START:DUR[:K]`` — workers [0, K) cut off from the rest
      for DUR seconds starting at START (K defaults to half the pool)

    Example: ``drop:0.1+partition:10:30:8``.
    """
    if spec is None:
        return None
    spec = spec.strip().lower()
    if spec in ("", "none"):
        return None
    faults: list[LinkFault] = []
    partitions: list[PartitionEvent] = []
    for part in spec.split("+"):
        toks = part.strip().split(":")
        kind = toks[0]
        try:
            if kind == "drop":
                faults.append(LinkFault(drop_prob=float(toks[1])))
            elif kind == "delay":
                faults.append(LinkFault(extra_delay=float(toks[1])))
            elif kind == "partition":
                start, dur = float(toks[1]), float(toks[2])
                side = _parse_side(toks[3] if len(toks) > 3 else "", num_workers)
                partitions.append(
                    PartitionEvent(side=side, start=start, duration=dur)
                )
            else:
                raise ValueError(f"unknown net-fault kind {kind!r}")
        except (IndexError, ValueError) as e:
            raise ValueError(f"bad net-fault spec {part!r}: {e}") from None
    return NetFaultSchedule(faults=tuple(faults), partitions=tuple(partitions))


def validate_netfaults(
    sched: NetFaultSchedule | None, num_workers: int
) -> None:
    """Reject schedules naming workers outside [0, num_workers)."""
    if sched is None:
        return
    bad = [w for w in sched.workers() if not 0 <= w < num_workers]
    if bad:
        raise ValueError(
            f"net-fault schedule names workers {sorted(bad)} outside "
            f"[0, {num_workers})"
        )
