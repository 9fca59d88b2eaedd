"""Straggler/limplock plane: fault injection + adaptive limp detection.

The paper's fault model (and ours, through PR 3) is binary — a worker is
alive or tombstoned.  Production heterogeneity has a third shape, the
dominant one at scale (Liu et al., PAPERS.md): a *limping* node that stays
alive but runs 10-100x slow (thermal throttle, noisy neighbor, IO stall).
Count-based stealing strands work on it; even the paper's t-weighted fair
share reacts only as fast as the published estimate, and the cumulative
mean ``t_i = runtime_sum/executed`` takes O(history) completions to admit a
mid-life collapse.

This module holds the plane-independent primitives (DESIGN.md §Straggler
plane); the threaded ``WorkerPool`` and the discrete-event simulator wire
them in identically so fault-injection scripts are cross-plane portable:

* :class:`SlowdownEvent` / :class:`SlowdownSchedule` — scriptable per-worker
  slowdown fault injection (step, ramp and transient events), the straggler
  analogue of PR 3's ``joins``/``retires`` churn scripts.  A schedule is a
  pure function ``factor_at(worker, t) -> multiplier`` of plane time, so the
  same script drives wall-clock stalls in the threaded plane and duration
  multipliers in the simulator.
* :class:`LimpConfig` / :class:`LimpState` — the owner-side detector: a fast
  EWMA over the worker's own completed-task durations (``recent``) against a
  slow own-baseline EWMA (``baseline``), flagged limping when the ratio
  crosses ``limp_factor`` and forgiven (hysteresis) when it falls back under
  ``recover_factor``.  The baseline FREEZES while limping so the collapsed
  regime cannot erode the healthy reference; recovery is driven entirely by
  ``recent`` decaying back — its half-life is pinned by
  :meth:`LimpConfig.recovery_half_life` and regression-tested.

Why own-trajectory and not peer-relative?  Static heterogeneity is the
paper's premise — a 1-core node is legitimately ~24x slower than a 24-core
one, and flagging it would fight the very fair-share mathematics (Eq. 5)
that already prices it correctly.  A limp is a *collapse against the
worker's own history*.  The ring-published peer baseline is used only as
the reference of last resort, for a worker that collapses before it has
``min_samples`` healthy completions of its own (boot-limped): there the
own baseline does not exist yet and the window median is the only signal.

Honest caveat (DESIGN.md §Straggler plane): the OWNER-side detector
observes only COMPLETED tasks.  A fully wedged worker (slowdown ->
infinity) never completes, never updates its EWMA, and never flags
itself.  ``LimpConfig.stale_after`` closes that blind spot from the PEER
side: the worker's own ring-cell version is its heartbeat (every
``update_local`` state change bumps it), and a version that stands still
for ``stale_after`` seconds gets the worker flagged limping by its peers
— routing-skip, re-pricing and limp-drain then fire exactly as for a
measured limp.  ``inf`` (default) keeps the pre-wedge behavior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "SlowdownEvent",
    "SlowdownSchedule",
    "LimpConfig",
    "LimpState",
    "normalize_duration",
    "effective_heartbeat",
]

_INF = float("inf")


def effective_heartbeat(hb: float, cut_start: float) -> float:
    """Observer-side heartbeat of a peer behind a cut link.

    The shared staleness primitive of the wedge detector
    (``LimpConfig.stale_after``) and the network-fault plane (DESIGN.md
    §Fault fabric): a heartbeat published after the link was cut cannot
    have crossed the fabric, so what the OBSERVER can actually see is the
    heartbeat capped at the cut instant.  ``cut_start = inf`` (a healthy
    link) is the identity; a NaN heartbeat (never reported) stays NaN.
    Both planes run their staleness comparison ``now - effective_hb >
    threshold`` on this value, so partition-caused silence flows through
    the exact same re-pricing path as a wedged worker — just scoped to
    the observer's own view row instead of the global limp flags.
    """
    if hb != hb:  # NaN: no heartbeat ever observed
        return hb
    return min(hb, cut_start)


@dataclass(frozen=True)
class SlowdownEvent:
    """One scripted slowdown of ``worker`` starting at plane time ``start``.

    ``factor`` multiplies the worker's task-execution time while the event
    is active (16.0 = 16x slower; values in (0, 1) model a speed-up and are
    allowed for completeness).  ``duration`` bounds the event — ``inf`` is a
    permanent *step*, finite gives a *transient* that fully recovers.
    ``ramp`` > 0 turns the onset into a linear *ramp*: the multiplier grows
    from 1 to ``factor`` over ``ramp`` seconds (thermal throttling rather
    than an instant stall).
    """

    worker: int
    start: float
    factor: float
    duration: float = _INF
    ramp: float = 0.0

    def __post_init__(self) -> None:
        if self.worker < 0:
            raise ValueError(f"slowdown worker {self.worker} must be >= 0")
        if not math.isfinite(self.start) or self.start < 0.0:
            raise ValueError(f"slowdown start {self.start} must be finite >= 0")
        if not math.isfinite(self.factor) or self.factor <= 0.0:
            raise ValueError(f"slowdown factor {self.factor} must be > 0")
        if self.duration <= 0.0:
            raise ValueError(f"slowdown duration {self.duration} must be > 0")
        if self.ramp < 0.0 or not math.isfinite(self.ramp):
            raise ValueError(f"slowdown ramp {self.ramp} must be finite >= 0")

    @property
    def end(self) -> float:
        """First instant the event no longer applies (inf for a step)."""
        if math.isinf(self.duration):
            return _INF
        return self.start + self.duration

    def factor_at(self, t: float) -> float:
        """Multiplier this event contributes at plane time ``t``."""
        if t < self.start or t >= self.end:
            return 1.0
        if self.ramp > 0.0:
            progress = min((t - self.start) / self.ramp, 1.0)
            return 1.0 + (self.factor - 1.0) * progress
        return self.factor


@dataclass(frozen=True)
class SlowdownSchedule:
    """A scriptable set of slowdown events (the straggler churn script).

    ``factor_at(worker, t)`` is the product of every active event's
    multiplier — overlapping faults compose multiplicatively, matching how
    independent interference sources behave on a real node.  Times are plane
    times: virtual seconds in the simulator, seconds since ``start()`` in
    the threaded pool.
    """

    events: tuple[SlowdownEvent, ...] = ()

    def __post_init__(self) -> None:
        # Accept any iterable of events but store a hashable tuple.
        object.__setattr__(self, "events", tuple(self.events))

    def factor_at(self, worker: int, t: float) -> float:
        f = 1.0
        for ev in self.events:
            if ev.worker == worker:
                f *= ev.factor_at(t)
        return f

    def workers(self) -> set[int]:
        return {ev.worker for ev in self.events}


@dataclass(frozen=True)
class LimpConfig:
    """Knobs of the owner-side limp detector (DESIGN.md §Straggler plane).

    * ``limp_factor``     — flag when ``recent / reference`` exceeds this.
    * ``recover_factor``  — unflag when the ratio falls back below this
      (hysteresis: must be < ``limp_factor`` or the flag would flap).
    * ``recent_alpha``    — fast EWMA over own completed-task durations; the
      collapse detector AND the forgiveness clock (see
      :meth:`recovery_half_life`).
    * ``baseline_alpha``  — slow EWMA forming the own healthy baseline;
      frozen while flagged so a long limp cannot erode the reference.
    * ``min_samples``     — completions before the own baseline is trusted;
      until then the ring-published peer median is the reference (covers a
      worker that collapses right after boot).
    * ``stale_after``     — the WEDGE detector (peer-side, satellite of the
      topology PR): seconds without the worker's own ring-cell version
      bumping before peers flag it limping anyway.  The owner-side EWMA
      only observes COMPLETED tasks, so a fully wedged worker
      (slowdown → ∞) never flags itself; ``update_local`` bumps the own
      version on every state change, so a version that stands still for
      ``stale_after`` seconds of communicate-windows is the heartbeat-loss
      signal.  ``inf`` (default) disables the check — bit-for-bit the
      pre-wedge detector.  Recovery is automatic: the next version bump
      clears the staleness flag (the EWMA hysteresis then owns the
      verdict again).
    * ``probation_every`` / ``probation_backoff_max`` — the canary path.
      The detector only observes COMPLETED tasks, and the response starves
      the flagged worker of exactly those: routing skips it and thieves
      strip its queue, so without a counter-measure a transient fault would
      blacklist it FOREVER.  Every ``probation_every``-th task that routing
      would have diverted away from a flagged worker is routed to it anyway
      as a probation canary; while canaries keep completing slow the gap
      doubles (exponential backoff, capped at ``probation_backoff_max``) so
      a permanently limping worker costs O(log T) canary latencies, and a
      healthy canary resets the gap so recovery is confirmed quickly.
    """

    limp_factor: float = 4.0
    recover_factor: float = 2.0
    recent_alpha: float = 0.5
    baseline_alpha: float = 0.05
    min_samples: int = 3
    probation_every: int = 4
    probation_backoff_max: int = 256
    stale_after: float = _INF

    def __post_init__(self) -> None:
        if self.limp_factor <= 1.0:
            raise ValueError("limp_factor must be > 1")
        if not 1.0 <= self.recover_factor < self.limp_factor:
            raise ValueError("need 1 <= recover_factor < limp_factor")
        for name in ("recent_alpha", "baseline_alpha"):
            a = getattr(self, name)
            if not 0.0 < a <= 1.0:
                raise ValueError(f"{name} must be in (0, 1]")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if self.probation_every < 1:
            raise ValueError("probation_every must be >= 1")
        if self.probation_backoff_max < self.probation_every:
            raise ValueError("probation_backoff_max must be >= probation_every")
        if not self.stale_after > 0.0:
            raise ValueError("stale_after must be > 0 (inf disables)")

    def recovery_half_life(self) -> float:
        """Healthy completions for ``recent`` to decay half-way back toward
        the true task time after a transient ends — the pinned forgiveness
        rate of the detector (tests/test_limplock.py).  With
        ``recent_alpha = 0.5`` that is exactly one completion."""
        if self.recent_alpha >= 1.0:
            return 1.0
        return math.log(0.5) / math.log(1.0 - self.recent_alpha)


def normalize_duration(dt: float, cls: int, class_t) -> float:
    """Scale a completed-task duration to average-class terms before feeding
    the detector, using the worker's OWN per-class EWMA t̂[c] (PR 4).

    Without this, a variable-cost workload (bimodal shots, 8x class ratio)
    trips the limp detector on every run of heavy tasks: the worker is not
    slower, its *work* is bigger.  Both planes apply the identical rule so
    fault scripts stay cross-plane portable.  ``class_t`` is the worker's
    t̂ row (or None when the workload is single-class — no-op then).
    """
    if class_t is None or len(class_t) <= 1:
        return dt
    ref = float(class_t[cls])
    if ref != ref or ref <= 0.0:
        return dt
    total = 0.0
    count = 0
    for v in class_t:
        v = float(v)
        if v == v:
            total += v
            count += 1
    mean = total / count  # count >= 1: class_t[cls] itself is finite
    if mean <= 0.0:
        return dt
    return dt * (mean / ref)


class LimpState:
    """Per-worker detector state; owner-thread-only, one per live worker.

    ``observe(dt)`` feeds one completed-task duration; ``evaluate(peer_ref)``
    re-derives the flag with hysteresis.  All floats, no locks — in the
    threaded plane only the owner thread touches the EWMAs, in the simulator
    there are no threads at all.  (Exception: ``should_probe`` is called by
    the SUBMITTER thread; its two int counters are GIL-atomic and a lost
    increment merely delays one canary by one diverted task.)
    """

    __slots__ = (
        "cfg", "recent", "baseline", "samples", "limping",
        "probe_gap", "diverted",
    )

    def __init__(self, cfg: LimpConfig) -> None:
        self.cfg = cfg
        self.recent = float("nan")
        self.baseline = float("nan")
        self.samples = 0
        self.limping = False
        self.probe_gap = cfg.probation_every
        self.diverted = 0

    def observe(self, dt: float) -> None:
        """Fold one completed-task duration into the EWMAs."""
        if not math.isfinite(dt) or dt <= 0.0:
            return  # defensive: clock glitches must not poison the detector
        self.samples += 1
        if self.recent != self.recent:
            self.recent = dt
        else:
            a = self.cfg.recent_alpha
            self.recent = a * dt + (1.0 - a) * self.recent
        limped_obs = (
            self.baseline == self.baseline
            and dt >= self.cfg.limp_factor * self.baseline
        )
        if self.limping:
            # Probation backoff: a still-slow canary doubles the probe gap,
            # a healthy one resets it so recovery gets confirmed quickly.
            if limped_obs:
                self.probe_gap = min(
                    self.probe_gap * 2, self.cfg.probation_backoff_max
                )
            else:
                self.probe_gap = self.cfg.probation_every
        elif not limped_obs:
            # Baseline freezes under collapse — including the collapse's
            # FIRST completion, which arrives before evaluate() can raise
            # the flag: an observation that alone crosses limp_factor is
            # an outlier by definition, never baseline material.
            # Forgiveness comes from ``recent`` falling back, never from
            # the baseline inflating up.
            if self.baseline != self.baseline:
                self.baseline = dt
            else:
                b = self.cfg.baseline_alpha
                self.baseline = b * dt + (1.0 - b) * self.baseline

    def should_probe(self) -> bool:
        """Routing calls this each time it would DIVERT a task away from
        this flagged worker: every ``probe_gap``-th diverted task returns
        True — route that one to the worker anyway as a probation canary
        (the only way a recovered worker can ever prove itself; see
        ``probation_every``).  An idle flagged worker starts the canary
        immediately, so thieves cannot snatch it back off the queue."""
        self.diverted += 1
        if self.diverted >= self.probe_gap:
            self.diverted = 0
            return True
        return False

    def ratio(self, peer_ref: float = float("nan")) -> float:
        """Speed-collapse ratio against the trusted reference (NaN = no
        reference yet — neither own history nor a peer baseline)."""
        if self.recent != self.recent:
            return float("nan")
        ref = self.baseline
        if self.samples < self.cfg.min_samples or ref != ref:
            ref = peer_ref
        if ref != ref or ref <= 0.0:
            return float("nan")
        return self.recent / ref

    def evaluate(self, peer_ref: float = float("nan")) -> bool:
        """Re-derive the limping flag (with hysteresis) and return it."""
        r = self.ratio(peer_ref)
        if r != r:
            return self.limping  # no reference: keep the current verdict
        if not self.limping and r > self.cfg.limp_factor:
            self.limping = True
            self.probe_gap = self.cfg.probation_every
            self.diverted = 0
        elif self.limping and r < self.cfg.recover_factor:
            self.limping = False
            self.probe_gap = self.cfg.probation_every
            self.diverted = 0
        return self.limping
