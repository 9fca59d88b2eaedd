"""Smart-stealing mathematics of A2WS (paper §2.2, Eqs. 2-10).

Host-side (scalar / numpy) implementation used by the threaded runtime and the
discrete-event simulator.  ``repro.core.device_sched`` re-implements the same
formulas in jnp for the jitted shard_map scheduler; ``tests/test_steal.py``
asserts the two agree.

Conventions
-----------
* ``n[j]``  -- TOTAL number of tasks of process j: already executed + queued
               (paper: "including the already executed and available").
* ``t[j]``  -- average runtime per task of process j (seconds).  Processes that
               have not yet finished a task report their *elapsed wall time*
               (preemptive stealing, §2.2.1) so they look progressively slower.
* ``S_i``   -- ideal steal rate of process i (Eq. 4/5).  S_i > 0: i must steal
               S_i tasks; S_i < 0: others should steal -S_i tasks from i.

Note on Eq. 6: the paper prints ``U(S) = (n_k + S)/t_k`` but defines speed as
``1/t_k`` (Eq. 2), so the expected *runtime* of ``n_k + S`` tasks is
``(n_k + S) * t_k``.  We implement the dimensionally-consistent product and
flag the discrepancy here; every downstream property (γ-rounding minimises the
pairwise makespan) only makes sense with the product form.

Work-weighted generalisation (DESIGN.md §Work-weighted stealing)
----------------------------------------------------------------
Eqs. 2-10 assume homogeneous tasks, so "queue depth" and "queued work" are
the same number.  Under variable task cost (seismic shots with different
``nt``/model sizes) every formula here generalises by measuring queues in
**equivalent reference-class tasks** instead of head counts:

* ``rel[c]``   — relative cost of class c vs the reference class
                 (:func:`class_relatives`; within one worker the speed
                 cancels, so its own per-class EWMA ratios estimate it).
* ``w_j``      — queued work ``Σ_c n_j[c]·rel[c]`` replaces the count.
* ``unit_j``   — mean work per queued task at j (:func:`queue_units`);
                 converts an Eq. 5/7 work amount back to an integer TASK
                 count for the Fig. 3b protocol.

``plan_steal`` takes the work vectors through the SAME ``(n, t, queued)``
parameters plus ``unit``/``qtasks`` keywords; with one class ``rel ≡ 1``,
``unit ≡ 1`` and ``qtasks ≡ queued``, every operation multiplies or divides
by exactly 1.0 — the count-based plan falls out bit-for-bit (property-tested
in ``tests/test_weighted.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "class_counts",
    "slo_split",
    "ideal_runtime",
    "tail_steal_amount",
    "steal_rate",
    "steal_rate_radius",
    "pair_steal_rate",
    "expected_runtime",
    "gamma",
    "round_steal_rate",
    "victim_weights",
    "select_victim",
    "neighborhood",
    "class_relatives",
    "queue_units",
    "weighted_overlay",
    "OverlayBuffers",
]

_EPS = 1e-12


def class_counts(
    tasks: Sequence,
    classifier: Callable[[object], int] | None,
    num_classes: int,
) -> list[int]:
    """Per-cost-class histogram of a task batch — THE loot/queue accounting
    both planes share (DESIGN.md §Work-weighted stealing).

    :class:`repro.core.deque.Task` records carry their class in ``.cls`` and
    are counted directly; bare payloads go through ``classifier`` (clamped
    to ``[0, num_classes)``; a raising classifier falls back to class 0 —
    accounting must never kill a worker).  ``classifier=None`` counts
    everything, Task or not, in class 0 — the count-based degenerate case.
    """
    from .deque import Task  # local: steal.py must stay import-light

    counts = [0] * max(num_classes, 1)
    hi = len(counts) - 1
    for task in tasks:
        if type(task) is Task:
            c = task.cls
        elif classifier is None:
            c = 0
        else:
            try:
                c = int(classifier(task))
            except Exception:
                c = 0
        counts[min(max(c, 0), hi)] += 1
    return counts


def slo_split(tasks: Sequence) -> tuple[int, int]:
    """``(batch, latency)`` counts of a loot batch (DESIGN.md §SLO serving).

    Telemetry for the owner-vs-thief asymmetry claim: thief-end steals strip
    the tail, so their loot should skew batch even when the victim's queue
    holds latency work.  Uses :func:`repro.core.deque.slo_of`, so it accepts
    Task records, future-likes and bare payloads alike.
    """
    from .deque import SLO_LATENCY, slo_of

    lat = sum(1 for task in tasks if slo_of(task)[0] == SLO_LATENCY)
    return len(tasks) - lat, lat


def ideal_runtime(n: Sequence[float], t: Sequence[float]) -> float:
    """Eq. 2: t_ideal = N / T with N = sum(n_j) and T = sum(1/t_j).

    Non-finite runtimes (``t̂ = NaN``: a neighbour that has never reported,
    e.g. at open-arrival boot) poison the harmonic sum ``T``; the guard
    returns NaN explicitly so callers treat it as "no information" rather
    than receiving an arbitrary NaN/inf arithmetic artefact.
    """
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if not np.isfinite(t).all():
        return float("nan")
    big_n = float(n.sum())
    big_t = float((1.0 / np.maximum(t, _EPS)).sum())
    return big_n / max(big_t, _EPS)


def steal_rate(i: int, n: Sequence[float], t: Sequence[float]) -> float:
    """Eq. 4: S_i = N / (t_i * T) - n_i over the FULL system."""
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    big_n = float(n.sum())
    big_t = float((1.0 / np.maximum(t, _EPS)).sum())
    return big_n / (max(float(t[i]), _EPS) * max(big_t, _EPS)) - float(n[i])


def neighborhood(i: int, num_procs: int, radius: int) -> list[int]:
    """Indices of the radius-R subsystem around i on the ring (Eq. 1).

    ``P_sub = 2R + 1`` positions, wrapping around the ring; if the radius
    covers the whole ring the neighborhood is simply every process once.
    """
    if 2 * radius + 1 >= num_procs:
        return list(range(num_procs))
    return [(i + d) % num_procs for d in range(-radius, radius + 1)]


def steal_rate_radius(
    i: int, n: Sequence[float], t: Sequence[float], radius: int
) -> float:
    """Eq. 5: the steal rate computed only over the radius-R subsystem.

    Returns NaN when any in-window runtime is non-finite (unreported
    neighbours at boot) — there is no basis for a fair share, and callers
    (``plan_steal``) must translate NaN into "no steal" instead of letting
    it corrupt victim probabilities downstream.
    """
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    idx = neighborhood(i, len(n), radius)
    if not np.isfinite(t[idx]).all():
        return float("nan")
    sub_n = float(n[idx].sum())
    sub_t = float((1.0 / np.maximum(t[idx], _EPS)).sum())
    return sub_n / (max(float(t[i]), _EPS) * max(sub_t, _EPS)) - float(n[i])


def pair_steal_rate(n_i: float, t_i: float, n_j: float, t_j: float) -> float:
    """Eq. 10 (simplified Eq. 9): in-pair steal rate of thief i vs victim j.

    S_j = (n_i + n_j) * t_j / (t_i + t_j) - n_i
    Positive => thief i should take S_j tasks from j when only the pair is
    considered (used when the subsystem looks balanced, §2.2.2).
    """
    return (n_i + n_j) * t_j / max(t_i + t_j, _EPS) - n_i


def expected_runtime(s: float, n_k: float, t_k: float) -> float:
    """Eq. 6: runtime of process k after its queue changes by ``s`` tasks."""
    return max(n_k + s, 0.0) * t_k


def gamma(
    s: float, n_thief: float, t_thief: float, n_victim: float, t_victim: float
) -> float:
    """Eq. 8: pairwise makespan if the thief steals ``s`` tasks."""
    return max(
        expected_runtime(-s, n_victim, t_victim),
        expected_runtime(+s, n_thief, t_thief),
    )


def round_steal_rate(
    s: float,
    n_thief: float,
    t_thief: float,
    n_victim: float,
    t_victim: float,
    unit: float = 1.0,
) -> int:
    """Eq. 7: round fractional S to the integer minimising γ (pair makespan).

    ``unit``: mean work per victim task (work-weighted mode).  ``s`` and the
    ``n`` arguments are then in work units while the returned amount stays an
    integer TASK count — γ is evaluated at ``k·unit`` work moved.  The
    default ``unit=1.0`` multiplies by exactly 1.0 everywhere, so the
    homogeneous path is unchanged bit-for-bit.
    """
    s_tasks = s / max(unit, _EPS)
    lo, hi = math.floor(s_tasks), math.ceil(s_tasks)
    if lo == hi:
        return int(lo)
    g_lo = gamma(lo * unit, n_thief, t_thief, n_victim, t_victim)
    g_hi = gamma(hi * unit, n_thief, t_thief, n_victim, t_victim)
    return int(lo) if g_lo < g_hi else int(hi)


def _distance_penalty(
    cand: np.ndarray,
    w: np.ndarray,
    tcost: "Callable[[int, int], float] | None",
    ref: float,
) -> np.ndarray:
    """Divide victim weights by ``1 + cost(j, 1)/ref`` (DESIGN.md §Topology
    plane): between equally-attractive victims, prefer the one whose loot is
    cheap to move.  ``ref`` is the thief's own per-task seconds, so the
    penalty is the per-task transfer cost measured in thief task-times.
    With ``tcost=None`` — or a model pricing every candidate at 0.0, where
    each weight divides by exactly 1.0 — the weights are bit-for-bit the
    unpriced ones."""
    if tcost is None:
        return w
    pen = np.array(
        [1.0 + max(float(tcost(int(j), 1)), 0.0) / ref for j in cand],
        dtype=np.float64,
    )
    return w / pen


def _health_factor(
    cand: np.ndarray,
    w: np.ndarray,
    health: "Callable[[int], float] | None",
) -> np.ndarray:
    """Multiply victim weights by the link-health factor (DESIGN.md §Fault
    fabric): 0.0 for a victim behind an active partition or a backed-off
    flaky link (excluded outright — the request cannot or should not be
    sent), the floor-clamped success EWMA for the rest.  ``health=None`` —
    or an all-healthy hook, where every factor is exactly 1.0 — leaves the
    weights bit-for-bit untouched (the multiply is skipped entirely)."""
    if health is None:
        return w
    f = np.array(
        [min(max(float(health(int(j))), 0.0), 1.0) for j in cand],
        dtype=np.float64,
    )
    if np.all(f >= 1.0):
        return w
    return w * f


def victim_weights(
    i: int,
    n: Sequence[float],
    t: Sequence[float],
    queued: Sequence[float],
    radius: int,
    tcost: "Callable[[int, int], float] | None" = None,
    link_health: "Callable[[int], float] | None" = None,
) -> tuple[np.ndarray, np.ndarray, str]:
    """Victim-selection probabilities (§2.2.2) for thief ``i``.

    Returns ``(candidates, weights, criterion)`` where ``criterion`` is
    ``"closest-rate"`` or ``"in-pair"``.

    Criterion 1 — *closest rate*: candidates are subsystem members with
    S_j < 0 (surplus) and a non-empty queue.  The best victim is the one whose
    surplus ``-S_j`` most closely matches the thief's deficit ``S_i`` (one
    steal balances both).  Weights scale with the surplus volume and decay
    with the mismatch, so concurrent thieves favour victims that can actually
    satisfy them while still spreading probabilistically (the paper specifies
    the criterion but not the exact weight; this is our realisation).

    Criterion 2 — *in-pair comparison* (Eq. 9/10): used when no candidate has
    S_j < 0 but queued tasks remain.  Each pair is evaluated in isolation and
    weighted by the pairwise steal volume.

    ``tcost``: optional ``(victim, ntasks) -> seconds`` transfer-cost hook
    (DESIGN.md §Topology plane).  Weights in BOTH criteria are divided by
    ``1 + cost/ref`` so nearby victims win ties; ``None`` (or an all-zero
    model) reproduces the unpriced weights bit-for-bit.

    ``link_health``: optional ``victim -> [0, 1]`` fault-plane hook
    (DESIGN.md §Fault fabric).  Weights in BOTH criteria are multiplied by
    the factor — 0.0 (partitioned / backed-off link) excludes the victim
    outright; ``None`` (or an all-healthy model) reproduces the weights
    bit-for-bit.
    """
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    queued = np.asarray(queued, dtype=np.float64)
    idx = [j for j in neighborhood(i, len(n), radius) if j != i]
    if not idx:
        return np.array([], dtype=np.int64), np.array([]), "closest-rate"

    ref = max(float(t[i]), _EPS) if math.isfinite(t[i]) else 1.0
    s_i = steal_rate_radius(i, n, t, radius)
    s_j = np.array([steal_rate_radius(j, n, t, radius) for j in idx])
    has_tasks = queued[idx] > 0.0

    surplus = (s_j < 0.0) & has_tasks
    if surplus.any():
        cand = np.asarray(idx, dtype=np.int64)[surplus]
        volume = -s_j[surplus]
        mismatch = np.abs(volume - max(s_i, 0.0))
        w = _distance_penalty(cand, volume / (1.0 + mismatch), tcost, ref)
        w = _health_factor(cand, w, link_health)
        w_sum = float(w.sum())
        if not math.isfinite(w_sum) or w_sum <= 0.0:
            # Every candidate priced unreachable (infinite-cost links).
            return np.array([], dtype=np.int64), np.array([]), "closest-rate"
        return cand, w / w_sum, "closest-rate"

    # In-pair fallback: the subsystem looks balanced yet queues are non-empty.
    pair = np.array(
        [pair_steal_rate(n[i], t[i], n[j], t[j]) for j in idx], dtype=np.float64
    )
    good = (pair > 0.0) & has_tasks
    if not good.any():
        return np.array([], dtype=np.int64), np.array([]), "in-pair"
    cand = np.asarray(idx, dtype=np.int64)[good]
    w = _distance_penalty(cand, pair[good], tcost, ref)
    w = _health_factor(cand, w, link_health)
    w_sum = float(w.sum())
    if not math.isfinite(w_sum) or w_sum <= 0.0:
        return np.array([], dtype=np.int64), np.array([]), "in-pair"
    return cand, w / w_sum, "in-pair"


def select_victim(
    rng: np.random.Generator,
    i: int,
    n: Sequence[float],
    t: Sequence[float],
    queued: Sequence[float],
    radius: int,
    tcost: "Callable[[int, int], float] | None" = None,
    link_health: "Callable[[int], float] | None" = None,
) -> tuple[int | None, str]:
    """Sample a victim for thief ``i`` (§2.2.2); None if no viable victim."""
    cand, w, crit = victim_weights(i, n, t, queued, radius, tcost, link_health)
    if len(cand) == 0:
        return None, crit
    return int(rng.choice(cand, p=w)), crit


class OverlayBuffers:
    """Preallocated scratch for :func:`weighted_overlay`, keyed on (P, C).

    The overlay sits on the per-boundary hot path and otherwise rebuilds a
    dozen (P,)- and (P, C)-sized temporaries per view.  A caller that runs
    many boundaries (one buffer per worker in the threaded pool, one per
    ring size in the simulator) passes the same buffer object back in; the
    overlay then writes into these arrays instead of allocating.

    The arrays RETURNED by a buffered ``weighted_overlay`` call alias this
    scratch — they are valid until the next overlay call with the same
    buffer, which is exactly one task boundary.  Never share one buffer
    across concurrently-deciding workers.
    """

    __slots__ = (
        "p", "c", "ratios", "both", "known", "ref_t", "finite", "mtmp",
        "t_w", "queued_w", "n_w", "exec_est", "unit", "vtmp",
    )

    def __init__(self, p: int, c: int) -> None:
        self.p, self.c = p, c
        self.ratios = np.empty((p, c), dtype=np.float64)
        self.both = np.empty((p, c), dtype=bool)
        self.known = np.empty((p, c), dtype=bool)
        self.ref_t = np.empty((p, c), dtype=np.float64)
        self.finite = np.empty((p, c), dtype=bool)
        self.mtmp = np.empty((p, c), dtype=np.float64)
        self.t_w = np.empty(p, dtype=np.float64)
        self.queued_w = np.empty(p, dtype=np.float64)
        self.n_w = np.empty(p, dtype=np.float64)
        self.exec_est = np.empty(p, dtype=np.float64)
        self.unit = np.empty(p, dtype=np.float64)
        self.vtmp = np.empty(p, dtype=np.float64)

    @classmethod
    def ensure(
        cls, buf: "OverlayBuffers | None", p: int, c: int
    ) -> "OverlayBuffers":
        """Reuse ``buf`` when it matches (P, C), else allocate a fresh one —
        elastic growth and cell migration change a worker's view size."""
        if buf is not None and buf.p == p and buf.c == c:
            return buf
        return cls(p, c)


def class_relatives(
    tc: np.ndarray, buf: OverlayBuffers | None = None
) -> np.ndarray:
    """Relative per-class costs ``rel[c]`` from a (P, C) matrix of per-worker
    per-class EWMA runtimes (NaN = that worker never ran that class).

    Within ONE worker the speed cancels: ``t̂_j[c]/t̂_j[a] = κ[c]/κ[a]``
    exactly under the separable cost model (duration = class cost / worker
    speed), so the primary estimator is the mean of own-worker ratios
    against the anchor class ``a`` (the lowest class anyone reported).
    Fallback when no worker reported both ``c`` and ``a``: the ratio of
    pool means (biased by which speeds saw which class, but better than
    nothing); a class nobody reported prices at 1.0 — the count-based
    degenerate value, so unknown classes never poison the plan.
    """
    tc = np.asarray(tc, dtype=np.float64)
    if tc.ndim != 2:
        raise ValueError("tc must be (num_workers, num_classes)")
    p, c = tc.shape
    rel = np.ones(c, dtype=np.float64)
    if buf is not None and (buf.p != p or buf.c != c):
        buf = None  # mismatched scratch: fall back to fresh temporaries
    known = (
        np.isfinite(tc) if buf is None else np.isfinite(tc, out=buf.known)
    )
    reported = known.any(axis=0)
    if not reported.any():
        return rel
    # Fully vectorised — this runs on every weighted ring view, a hot path.
    anchor = int(np.argmax(reported))  # lowest class with any report
    base = tc[:, anchor]
    known_a = known[:, anchor]
    # (P, C): worker knows anchor AND class
    if buf is None:
        both = known_a[:, None] & known
        ratios = np.divide(tc, base[:, None], out=np.ones_like(tc), where=both)
        masked = np.where(both, ratios, 0.0)
    else:
        both = np.logical_and(known_a[:, None], known, out=buf.both)
        buf.ratios.fill(1.0)
        ratios = np.divide(tc, base[:, None], out=buf.ratios, where=both)
        buf.mtmp.fill(0.0)
        np.copyto(buf.mtmp, ratios, where=both)
        masked = buf.mtmp
    n_both = both.sum(axis=0)
    with np.errstate(invalid="ignore"):
        rel_ratio = masked.sum(axis=0) / n_both
    # Pool-mean fallback for classes no worker reported alongside the anchor.
    col_cnt = known.sum(axis=0)
    if buf is None:
        col_masked = np.where(known, tc, 0.0)
    else:
        buf.mtmp.fill(0.0)
        np.copyto(buf.mtmp, tc, where=known)
        col_masked = buf.mtmp
    with np.errstate(invalid="ignore"):
        col_mean = col_masked.sum(axis=0) / col_cnt
    anchor_mean = col_mean[anchor]
    use_ratio = n_both > 0
    use_pool = (~use_ratio) & reported & (anchor_mean > 0.0)
    rel = np.where(use_ratio, rel_ratio, rel)
    rel = np.where(use_pool, col_mean / max(anchor_mean, _EPS), rel)
    rel[~reported] = 1.0
    rel[anchor] = 1.0
    return np.maximum(rel, _EPS)


def queue_units(
    nc: np.ndarray, rel: np.ndarray, buf: OverlayBuffers | None = None
) -> np.ndarray:
    """Mean work per queued task, per worker: ``unit_j = Σ_c nc_j[c]·rel[c]
    / Σ_c nc_j[c]`` from a (P, C) matrix of per-class queue counts.  Workers
    with no class information (empty or unreported queue) price at 1.0 —
    the count-based degenerate value."""
    nc = np.asarray(nc, dtype=np.float64)
    rel = np.asarray(rel, dtype=np.float64)
    if buf is not None and buf.p == nc.shape[0] and buf.c == nc.shape[1]:
        tot = nc.sum(axis=1, out=buf.vtmp)
        work = np.matmul(nc, rel, out=buf.unit)
        np.divide(work, np.maximum(tot, _EPS), out=work)
        work[tot <= 0.0] = 1.0
        return work
    tot = nc.sum(axis=1)
    work = nc @ rel
    return np.where(tot > 0.0, work / np.maximum(tot, _EPS), 1.0)


def weighted_overlay(
    n: np.ndarray,
    t: np.ndarray,
    queued: np.ndarray,
    nc: np.ndarray,
    tc: np.ndarray,
    frozen: np.ndarray | None = None,
    buf: OverlayBuffers | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The work-weighted re-pricing shared by BOTH planes (DESIGN.md
    §Work-weighted stealing): from count-denominated view rows ``(n, t,
    queued)`` and the per-class board rows ``(nc, tc)``, derive

    * ``rel``/``unit`` — class relatives and mean work per queued task,
    * ``t_w``        — seconds per REFERENCE task (``t̂[c]/rel[c]`` mean;
      the per-task mean conflates speed with queue mix).  Rows with no
      class report, and rows masked by ``frozen`` (tombstones priced at
      ~0 speed), keep their scalar estimate,
    * ``queued_w``/``n_w`` — queue and total in equivalent reference-class
      tasks (executed history converts by ``t/t_w``),
    * ``qtasks``     — the original count estimates (integrality guards and
      the Fig. 3b clamp).

    Returns ``(n_w, t_w, queued_w, unit, qtasks, rel)``.  One
    implementation on purpose: the threaded runtime and the simulator must
    price identically or cross-plane conformance is meaningless.

    ``buf``: optional :class:`OverlayBuffers` scratch keyed on (P, C).  The
    returned arrays then alias the buffer (valid for one task boundary) —
    results are numerically identical with or without it.
    """
    if buf is not None and (buf.p != tc.shape[0] or buf.c != tc.shape[1]):
        buf = None  # mismatched scratch (elastic growth): allocate fresh
    rel = class_relatives(tc, buf)
    unit = queue_units(nc, rel, buf)
    with np.errstate(invalid="ignore"):
        ref_t = (
            tc / rel if buf is None else np.divide(tc, rel, out=buf.ref_t)
        )
    finite = (
        np.isfinite(ref_t) if buf is None
        else np.isfinite(ref_t, out=buf.finite)
    )
    rows = finite.any(axis=1)
    if frozen is not None:
        rows &= ~np.asarray(frozen, dtype=bool)
    t_w = t.copy() if buf is None else np.copyto(buf.t_w, t) or buf.t_w
    # Per-row mean of the finite reference-priced estimates, vectorised:
    # summing masked zeros is exact (adding 0.0 never changes a float), so
    # this is the same value as the per-row compress-and-mean it replaced.
    if rows.any():
        if buf is None:
            msum = np.where(finite, ref_t, 0.0).sum(axis=1)
        else:
            buf.mtmp.fill(0.0)
            np.copyto(buf.mtmp, ref_t, where=finite)
            msum = buf.mtmp.sum(axis=1)
        cnt = finite.sum(axis=1)
        np.copyto(t_w, msum / np.maximum(cnt, 1), where=rows)
    qtasks = queued
    if buf is None:
        queued_w = queued * unit
        exec_est = np.maximum(n - queued, 0.0)
        n_w = exec_est * (t / np.maximum(t_w, 1e-12)) + queued_w
    else:
        queued_w = np.multiply(queued, unit, out=buf.queued_w)
        exec_est = np.subtract(n, queued, out=buf.exec_est)
        np.maximum(exec_est, 0.0, out=exec_est)
        ratio = np.divide(t, np.maximum(t_w, 1e-12), out=buf.vtmp)
        n_w = np.multiply(exec_est, ratio, out=buf.n_w)
        n_w += queued_w
    return n_w, t_w, queued_w, unit, qtasks, rel


@dataclass(frozen=True)
class StealDecision:
    """A fully-resolved steal: victim and integer task count.

    ``work``: the plan's loot target in equivalent reference-class tasks
    (``amount × unit_victim``) — 0.0 in count mode.  A weighted substrate
    executes the steal greedily by work (``TaskDeque.steal_by_work``), so
    the amount actually moved tracks the planned work-seconds even when the
    victim's tail composition differs from its mean unit."""

    victim: int
    amount: int
    criterion: str
    work: float = 0.0


def tail_steal_amount(
    q_thief: float,
    t_thief: float,
    q_victim: float,
    t_victim: float,
    *,
    open_arrival: bool = False,
    unit_victim: float = 1.0,
    thief_tasks: float | None = None,
) -> int:
    """γ-optimal steal count on REMAINING work (the §2.2 'final stages' rule).

    Minimises ``max((q_v - k)·t_v, (q_i + k)·t_i)`` over integer k — the pair
    makespan from *now* — and returns k only if it strictly beats k = 0.
    Used when the thief is (nearly) idle: it prevents a fast process from
    idling while a slow one still holds queued tasks, and conversely returns
    0 when a slow thief would only stretch the pair makespan.

    ``open_arrival``: under open arrivals (tasks injected while the system
    runs) the closed-workload tie-break inverts for an EMPTY thief.  In a
    closed run a tie steal is pointless churn ("slow processes cannot steal
    at the end"); in an open run the victim's queue depth q_v excludes the
    task it is currently executing, so a tied γ still leaves the stolen task
    waiting behind the victim's in-flight work while the thief idles — a pure
    per-task latency loss.  An idle (q_i = 0) thief therefore accepts ties
    (k ≥ 1 whenever γ(k) ≤ γ(0)), which is what keeps freshly injected tasks
    from being stranded on a busy worker's deque.

    Work-weighted mode: ``q_victim`` stays the victim's TASK count while
    ``q_thief`` is the thief's queued WORK and ``unit_victim`` the mean work
    per victim task, so γ compares drain times of heterogeneous queues but
    ``k`` remains an integer task count for the Fig. 3b protocol.
    ``thief_tasks`` is the thief's task count for the idle tie rule
    (defaults to ``q_thief`` — identical in the homogeneous case).  Any
    non-finite input means "no information": return 0 (no steal) instead of
    propagating NaN into ``int()``.
    """
    if not all(
        math.isfinite(v) for v in (q_thief, t_thief, q_victim, t_victim)
    ):
        return 0
    if q_victim < 1.0:
        return 0
    u = max(unit_victim, _EPS)
    if thief_tasks is None:
        thief_tasks = q_thief
    w_victim = q_victim * u
    k_star = (w_victim * t_victim - q_thief * t_thief) / max(
        u * (t_thief + t_victim), _EPS
    )
    best_k, best_g = 0, max(w_victim * t_victim, q_thief * t_thief)
    for k in {math.floor(k_star), math.ceil(k_star), 1}:
        k = int(min(max(k, 0), q_victim))
        g = max((w_victim - k * u) * t_victim, (q_thief + k * u) * t_thief)
        if g < best_g - 1e-12 or (g == best_g and k < best_k):
            best_k, best_g = k, g
    if open_arrival and best_k == 0 and thief_tasks < 1.0:
        # Accept a tie: one task moves to the idle thief if that does not
        # strictly worsen the pair bound (it starts immediately instead of
        # queueing behind the victim's in-flight task).
        g1 = max((w_victim - u) * t_victim, (q_thief + u) * t_thief)
        if g1 <= best_g + 1e-12:
            return 1
    return best_k


def plan_steal(
    rng: np.random.Generator,
    i: int,
    n: Sequence[float],
    t: Sequence[float],
    queued: Sequence[float],
    radius: int,
    idle: bool = False,
    open_arrival: bool = False,
    *,
    unit: Sequence[float] | None = None,
    qtasks: Sequence[float] | None = None,
    transfer_cost: Callable[[int, int], float] | None = None,
    link_health: Callable[[int], float] | None = None,
) -> StealDecision | None:
    """End-to-end smart-stealing decision for thief ``i`` (Alg. 1 lines 4-6).

    Computes S_i (Eq. 5), selects a victim (§2.2.2), rounds with γ (Eq. 7) and
    clamps to the victim's queued tasks.  Returns None when i should not steal.

    ``idle``: the thief's deque is (nearly) empty.  Preemptive stealing
    (S_i > 0 on TOTAL task counts, Eqs. 4-8) is the primary mechanism; a
    (nearly) idle thief additionally applies the remaining-work γ tail rule
    (``tail_steal_amount``) so that (a) fast processes never idle while slow
    ones hold queued tasks (the paper's "final stages" behaviour) and (b)
    the §2.1 relay works — an intermediary with S_i <= 0 still pulls tasks
    across the ring when that strictly reduces the pair makespan, letting a
    distant fast process re-steal them.

    ``open_arrival``: the workload is open (tasks keep arriving while the
    scheduler runs, DESIGN.md §Open-arrival).  The paper's cumulative totals
    ``n_j`` (executed + available, §2.2) are meaningless as a balance target
    when the ground keeps shifting, so Eq. 5 is evaluated on the
    INSTANTANEOUS queue depths instead: ``S_i = Q_sub/(t_i·T_sub) − q_i`` is
    the fair share of the *remaining* work in the radius-R window.  Callers
    must then pass reported depths via ``queued`` (no elapsed-time
    extrapolation — depth both drains and refills under arrivals) and the
    tail rule runs in its latency-oriented tie-accepting form.

    ``transfer_cost``: optional ``(victim, ntasks) -> seconds`` network
    pricing hook (DESIGN.md §Topology plane).  Victim weights are
    distance-penalized, and a sized plan is priced as *work-gained minus
    transfer-cost*: the γ improvement of moving the loot (seconds) must
    exceed the cost of moving it, else the steal is REFUSED — a refused
    preemptive plan falls through to the tail rule (which may find a
    nearer victim), a refused tail plan returns None.  ``None``, or a
    model pricing every link at 0.0, reproduces the unpriced plan
    bit-for-bit, rng stream included.

    ``link_health``: optional ``victim -> [0, 1]`` fault-plane hook
    (DESIGN.md §Fault fabric): victim weights in the preemptive AND tail
    draws are multiplied by the factor, so partitioned or backed-off
    victims (factor 0) are never targeted and flaky links are discounted.
    ``None``, or an all-healthy model, reproduces the plan bit-for-bit,
    rng stream included.

    ``unit``/``qtasks``: work-weighted mode (DESIGN.md §Work-weighted
    stealing).  ``n``/``queued`` are then measured in equivalent
    reference-class tasks (``w_j = Σ_c n_j[c]·rel[c]``), ``unit[j]`` is the
    mean work per queued task at j (converts Eq. 5/7 work amounts back to
    integer task counts) and ``qtasks[j]`` the actual queued task count
    (integrality guards and the Fig. 3b clamp).  Defaults (``None``) are the
    homogeneous identities — every operation multiplies by exactly 1.0, so
    the count-based plan is reproduced bit-for-bit, rng stream included.
    """
    n = np.asarray(n, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    queued = np.asarray(queued, dtype=np.float64)
    weighted = unit is not None
    unit = (
        np.ones_like(queued)
        if unit is None
        else np.maximum(np.asarray(unit, dtype=np.float64), _EPS)
    )
    qtasks = queued if qtasks is None else np.asarray(qtasks, dtype=np.float64)
    if open_arrival:
        # Fair-share balance on remaining work: depths replace totals in
        # Eqs. 4-8; the γ-rounding already operates on "work after the
        # steal", which is exactly the depth semantics.
        n = queued
    s_i = steal_rate_radius(i, n, t, radius)
    # NaN guard: an all-unreported window (open-arrival boot, every t̂ NaN)
    # yields a NaN steal rate — no basis for Eq. 5, so no preemptive plan
    # (the tail rule below still works against reported victims).
    if math.isfinite(s_i) and s_i > 0.0:
        victim, crit = select_victim(
            rng, i, n, t, queued, radius, transfer_cost, link_health
        )
        if victim is not None:
            if crit == "in-pair":
                s = pair_steal_rate(
                    float(n[i]), float(t[i]), float(n[victim]), float(t[victim])
                )
            else:
                s = min(s_i, -steal_rate_radius(victim, n, t, radius))
            if s > 0.0:
                amount = round_steal_rate(
                    s, float(n[i]), float(t[i]), float(n[victim]), float(t[victim]),
                    unit=float(unit[victim]),
                )
                amount = int(min(amount, qtasks[victim]))
                if amount >= 1:
                    # Net pricing (§Topology plane): the γ improvement of
                    # moving the loot must beat the cost of moving it.  A
                    # refused plan falls through to the tail rule, which
                    # distance-penalizes toward nearer victims.
                    refused = False
                    if transfer_cost is not None:
                        cost = max(
                            float(transfer_cost(int(victim), int(amount))), 0.0
                        )
                        if cost > 0.0:
                            u = float(unit[victim])
                            args = (
                                float(n[i]), float(t[i]),
                                float(n[victim]), float(t[victim]),
                            )
                            gain = gamma(0.0, *args) - gamma(amount * u, *args)
                            refused = not (gain > cost)
                    if not refused:
                        return StealDecision(
                            victim=victim, amount=amount, criterion=crit,
                            work=(
                                amount * float(unit[victim]) if weighted else 0.0
                            ),
                        )

    # Tail rule: γ on remaining (queued) work against a probabilistically
    # chosen loaded victim.  This is the "final stages" behaviour of §2.2 —
    # a fast process must not idle while a slower one holds queued tasks.
    #
    # Guards: (a) victim queue estimates are FLOORED — tasks are integral,
    # and a fractional estimate (q=1.04) must not let a thief see a strict
    # γ-improvement where the true comparison is a tie (this enforces the
    # paper's "slow processes cannot steal at the end"); (b) a BUSY thief may
    # only tail-steal from victims at most as fast as itself — a pairwise
    # improvement that parks work on a slow node is a global regression
    # (other fast thieves would have drained that victim).  Idle thieves are
    # exempt from (b): that is the §2.1 relay (γ still protects the pair).
    window = [j for j in neighborhood(i, len(n), radius) if j != i]
    loaded = [
        j for j in window
        if math.floor(qtasks[j]) >= 1
        and (idle or t[i] <= t[j])
        and math.isfinite(t[j])
        and math.isfinite(queued[j])
    ]
    if not loaded:
        return None
    w = np.array([queued[j] * t[j] for j in loaded], dtype=np.float64)
    if transfer_cost is not None:
        ref = max(float(t[i]), _EPS) if math.isfinite(t[i]) else 1.0
        w = _distance_penalty(
            np.asarray(loaded, dtype=np.int64), w, transfer_cost, ref
        )
    w = _health_factor(np.asarray(loaded, dtype=np.int64), w, link_health)
    w_sum = float(w.sum())
    if not math.isfinite(w_sum) or w_sum <= 0.0:
        return None  # degenerate weights (NaN boot state / zero work)
    victim = int(rng.choice(loaded, p=w / w_sum))
    amount = tail_steal_amount(
        float(queued[i]), float(t[i]),
        float(math.floor(qtasks[victim])), float(t[victim]),
        open_arrival=open_arrival,
        unit_victim=float(unit[victim]),
        thief_tasks=float(qtasks[i]),
    )
    if amount < 1:
        return None
    if transfer_cost is not None:
        cost = max(float(transfer_cost(int(victim), int(amount))), 0.0)
        if cost > 0.0:
            # Net pricing on REMAINING work, mirroring tail_steal_amount's
            # γ: refuse when the pair-makespan improvement (plus, for an
            # idle open-arrival thief, the per-task wait the rescue saves)
            # does not beat the transfer cost.
            u = max(float(unit[victim]), _EPS)
            w_v = float(math.floor(qtasks[victim])) * u
            q_i, t_i_s, t_v = float(queued[i]), float(t[i]), float(t[victim])
            g0 = max(w_v * t_v, q_i * t_i_s)
            g1 = max((w_v - amount * u) * t_v, (q_i + amount * u) * t_i_s)
            rescue = (
                u * t_v
                if open_arrival and float(qtasks[i]) < 1.0
                else 0.0
            )
            if not (g0 - g1 + rescue > cost):
                return None
    return StealDecision(
        victim=victim, amount=amount, criterion="tail",
        work=amount * float(unit[victim]) if weighted else 0.0,
    )
