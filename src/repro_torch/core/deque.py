"""Asynchronous-theft task deque (paper §2.3).

The paper controls deque access with MPI one-sided operations:

* Fig. 2 — a lock protocol: the owner takes from the *head* (exclusive lock on
  head+tail, shared lock on the deque body); the thief shifts the *tail*
  (exclusive head+tail), transfers task payloads, then exclusively locks its
  own deque to append.
* Fig. 3b — the optimisation this paper contributes: head and tail are packed
  into a **single word** so one atomic ``MPI_Get_accumulate`` both claims tail
  slots and returns a consistent (head, tail) snapshot — 7 communication ops
  collapse to 4.  When the snapshot reveals fewer available tasks than
  requested, an *occasional* ``MPI_Accumulate`` returns the overdraft (dashed
  arrow in Fig. 3b), and a victim observing ``tail < head`` classifies its
  deque as empty.

TPU/JAX adaptation: there is no remote atomic inside an XLA program, so this
structure lives in the **host control plane** (shared memory between worker
threads stands in for RDMA windows; on a real cluster the same protocol runs
between per-host scheduler agents).  ``AtomicInt64`` emulates a single
hardware fetch-and-add — its lock guards exactly one 64-bit read-modify-write
and is *never* held across a task transfer, preserving the paper's
no-lock-across-communication property.

Layout: slots live in a growable ring buffer addressed by absolute indices;
valid tasks occupy ``[head, tail)``.  The owner pops at ``head`` (head += 1);
a thief claims ``k`` slots at the tail (tail -= k) and receives ``[tail',
tail' + k)``.  New/stolen tasks are pushed at the head side (head -= 1), which
matches the paper: "new tasks are initially added to the head".
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Sequence

__all__ = [
    "AtomicInt64", "pack", "unpack", "TaskDeque", "StealResult",
    "Task", "SLO_BATCH", "SLO_LATENCY", "SLO_NAMES", "slo_of", "slo_key",
]

_HALF = 32
_MASK = (1 << _HALF) - 1
_BIAS = 1 << (_HALF - 1)  # biased encoding so head/tail may go "negative"


def pack(head: int, tail: int) -> int:
    """Pack (head, tail) into one 64-bit word: head in the high half."""
    return ((head + _BIAS) << _HALF) | ((tail + _BIAS) & _MASK)


def unpack(word: int) -> tuple[int, int]:
    head = (word >> _HALF) - _BIAS
    tail = (word & _MASK) - _BIAS
    return head, tail


#: SLO classes (DESIGN.md §SLO serving).  Two classes on purpose — the
#: ordering rule is "latency jumps batch, EDF within class"; finer tiers are
#: a deadline choice, not a new class.
SLO_BATCH = 0
SLO_LATENCY = 1
SLO_NAMES = ("batch", "latency")


class Task:
    """THE task record — the one encoding every layer shares.

    Before this record, per-task metadata accreted one parallel encoding per
    plane: the simulator carried ``(arrival, class)`` tuples, the threaded
    pool stamped arrivals in a side dict keyed by ``id(payload)``, ServePool
    wrapped requests in futures, and cost classes lived in a classifier
    closure.  ``Task`` is the superset, defined once:

    * ``id``       — stable integer identity (trace index / submission seq).
    * ``arrival``  — submission time in the owning plane's clock (virtual
      seconds in the simulator, ``perf_counter`` in the pool); NaN = closed
      workload, no latency accounting.
    * ``cls``      — cost class in ``[0, num_classes)`` (PR-4 weighted
      stealing); classifier-free substrates read it directly.
    * ``slo``      — :data:`SLO_LATENCY` or :data:`SLO_BATCH`.
    * ``deadline`` — absolute completion deadline (same clock as
      ``arrival``); ``inf`` = none.
    * ``payload``  — the actual work item, opaque to the scheduler.

    Plain payloads remain legal everywhere (:func:`slo_of` defaults them to
    batch/no-deadline), which is what keeps the degenerate no-SLO
    configuration bit-for-bit the PR-9 scheduler.
    """

    __slots__ = ("id", "arrival", "cls", "slo", "deadline", "payload")

    def __init__(
        self,
        id: int = -1,
        arrival: float = math.nan,
        cls: int = 0,
        slo: int = SLO_BATCH,
        deadline: float = math.inf,
        payload: object = None,
    ) -> None:
        self.id = id
        self.arrival = arrival
        self.cls = cls
        self.slo = slo
        self.deadline = deadline
        self.payload = payload

    def __repr__(self) -> str:  # telemetry/debug only
        return (
            f"Task(id={self.id}, arrival={self.arrival:.6g}, cls={self.cls},"
            f" slo={SLO_NAMES[self.slo]}, deadline={self.deadline:.6g})"
        )


def slo_of(task) -> tuple[int, float, float]:
    """``(slo, deadline, arrival)`` of ANY payload the runtime may carry.

    :class:`Task` records answer from their fields; future-like payloads
    (``ServeFuture``) answer from ``slo_class``/``deadline``/``submit_t``
    attributes; every other payload is batch-class with no deadline and an
    unknown arrival — the degenerate values under which SLO ordering is a
    no-op.  ``deadline`` is normalised to ``inf`` when absent/NaN, arrival
    to NaN when unknown.
    """
    if type(task) is Task:
        d = task.deadline
        return task.slo, (math.inf if d != d else d), task.arrival
    s = getattr(task, "slo_class", None)
    if s is None:
        return SLO_BATCH, math.inf, math.nan
    d = getattr(task, "deadline", None)
    a = getattr(task, "submit_t", None)
    d = math.inf if d is None or d != d else float(d)
    a = math.nan if a is None else float(a)
    return int(s), d, a


def slo_key(now: float, aging: float = math.inf) -> Callable:
    """Owner-pop ordering key for :meth:`TaskDeque.get_task` (DESIGN.md
    §SLO serving).  Smaller ranks pop first; exact ties resolve head-most
    (newest), which preserves batch LIFO under the hood.

    Rank layout: latency-class tasks rank ``(0, deadline)`` — EDF, with
    deadline-free latency tasks at ``(0, inf)``.  A batch task older than
    ``aging`` seconds is PROMOTED to rank ``(0, arrival + aging)`` — it
    competes in the same EDF order as latency work, which is the
    no-starvation bound: a latency flood can delay a batch task by at most
    ``aging`` plus the latency backlog ahead of its effective deadline.
    Fresh batch tasks rank ``(1, 0.0)`` — always behind latency, tie-broken
    newest-first (LIFO).
    """
    def key(task) -> tuple[int, float]:
        s, d, a = slo_of(task)
        if s == SLO_LATENCY:
            return (0, d)
        if aging < math.inf and a == a and (now - a) > aging:
            return (0, a + aging)
        return (1, 0.0)
    return key


class AtomicInt64:
    """A single 64-bit cell with fetch-and-add — the RDMA-atomic stand-in.

    ``get_accumulate(delta)`` is the MPI_Get_accumulate of Fig. 3b: atomically
    adds ``delta`` and returns the PREVIOUS value.  ``accumulate(delta)`` is
    the occasional correction op.  The internal lock covers one integer
    read-modify-write only.
    """

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0) -> None:
        self._value = value
        self._lock = threading.Lock()

    def load(self) -> int:
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value

    def get_accumulate(self, delta: int) -> int:
        with self._lock:
            old = self._value
            self._value = old + delta
            return old

    def accumulate(self, delta: int) -> None:
        with self._lock:
            self._value += delta

    def compare_exchange(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._value != expected:
                return False
            self._value = desired
            return True


class _RWLock:
    """Shared/exclusive lock mirroring MPI_Win_lock(SHARED|EXCLUSIVE)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    def acquire_shared(self) -> None:
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1

    def release_shared(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_exclusive(self) -> None:
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True

    def release_exclusive(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class StealResult:
    """Outcome of ``TaskDeque.steal``: the tasks plus protocol telemetry.

    ``observed_head``/``observed_tail`` are the pre-image snapshot returned by
    the single Get-accumulate — the thief learns the victim's exact queue
    state for free, which feeds its information vector (Table 1 rows 2-3).
    """

    __slots__ = (
        "tasks", "requested", "adjusted", "corrected",
        "observed_head", "observed_tail",
    )

    def __init__(
        self,
        tasks: list,
        requested: int,
        adjusted: int,
        corrected: bool,
        observed_head: int = 0,
        observed_tail: int = 0,
    ):
        self.tasks = tasks
        self.requested = requested
        self.adjusted = adjusted
        self.corrected = corrected
        self.observed_head = observed_head
        self.observed_tail = observed_tail

    def __bool__(self) -> bool:  # truthy iff anything was stolen
        return bool(self.tasks)


class TaskDeque:
    """Owner-head / thief-tail deque with packed-word asynchronous theft."""

    def __init__(self, tasks: Iterable | None = None) -> None:
        items = list(tasks) if tasks is not None else []
        self._slots: dict[int, object] = {k: v for k, v in enumerate(items)}
        self.headtail = AtomicInt64(pack(0, len(items)))
        self.body = _RWLock()  # the "deque" window of Fig. 2
        # Telemetry (read by the info vector / tests; not part of the protocol)
        self.steals_suffered = 0
        self.corrections = 0
        self._telemetry_lock = threading.Lock()
        # Content-change hint for accounting caches (work-weighted queue
        # composition): bumped on every successful pop/push/steal.  Plain
        # int — a racy lost increment merely risks one stale accounting
        # read, which the next publish corrects.
        self.mutations = 0

    # ------------------------------------------------------------------ owner
    def get_task(self, key: Callable | None = None):
        """Fig. 2a: owner pops from the head.  Returns task or None if empty.

        (I) exclusive lock head+tail -> our single-word CAS loop: a CAS on the
        packed word is the degenerate exclusive lock over exactly that word;
        (II) shared lock on the body while reading the slot; (III) move head;
        (IV) unlock.

        ``key``: optional SLO-ordering key (:func:`slo_key`).  ``None`` —
        the default, and the only path any no-SLO substrate takes — is the
        plain head pop above, bit-for-bit the PR-9 protocol.  With a key the
        owner pops the MINIMUM-key task from anywhere in ``[head, tail)``
        (ties resolve head-most, i.e. newest).  Protocol: the owner takes an
        EXCLUSIVE body lock — thieves may still CLAIM tail slots (the
        packed-word get-accumulate is not body-locked) but cannot TRANSFER
        payloads (Fig. 2b step III needs the shared body lock) — scans the
        live range, CASes ``head + 1`` exactly as the plain pop does, then
        swaps the head payload into the popped task's slot so the range
        ``[head+1, tail)`` stays fully populated for any thief whose claim
        serialised after our CAS.  A claim that serialises before our CAS
        fails it and we rescan against the shrunken range.  Only the OWNER
        end reorders: the thief end still strips the oldest/cheapest tail
        slots first, which is what makes steals drain batch work
        preferentially (DESIGN.md §SLO serving).  ``key`` runs under the
        exclusive lock — it must be cheap and must not touch this deque.
        """
        if key is None:
            while True:
                word = self.headtail.load()
                head, tail = unpack(word)
                if head >= tail:  # empty (incl. thief-overdraft tail < head)
                    if tail < head:
                        self._note_overdraft()
                    return None
                self.body.acquire_shared()
                try:
                    if not self.headtail.compare_exchange(word, pack(head + 1, tail)):
                        continue  # a thief moved the tail under us: retry
                    task = self._slots.pop(head)
                    self.mutations += 1
                finally:
                    self.body.release_shared()
                return task
        missing = object()
        self.body.acquire_exclusive()
        try:
            while True:
                word = self.headtail.load()
                head, tail = unpack(word)
                if head >= tail:
                    if tail < head:
                        self._note_overdraft()
                    return None
                best_rank, best_k = None, head
                for k in range(head, tail):
                    cand = self._slots.get(k, missing)
                    if cand is missing:  # defensively skip claimed slots
                        continue
                    rank = key(cand)
                    if best_rank is None or rank < best_rank:
                        best_rank, best_k = rank, k
                if not self.headtail.compare_exchange(word, pack(head + 1, tail)):
                    continue  # a thief moved the tail under us: rescan
                task = self._slots.pop(best_k)
                if best_k != head:
                    # Refill the hole with the head payload: thieves that
                    # claimed after our CAS transfer from [head+1, tail),
                    # which must stay gap-free.
                    self._slots[best_k] = self._slots.pop(head)
                self.mutations += 1
                return task
        finally:
            self.body.release_exclusive()

    def push(self, tasks: Sequence) -> None:
        """Owner (or thief landing stolen goods) pushes at the head side.

        Fig. 2b step (IV): exclusive lock on own deque body while appending.
        """
        if not tasks:
            return
        self.body.acquire_exclusive()
        try:
            while True:
                word = self.headtail.load()
                head, tail = unpack(word)
                new_head = head - len(tasks)
                if self.headtail.compare_exchange(word, pack(new_head, tail)):
                    break
            for off, task in enumerate(tasks):
                self._slots[new_head + off] = task
            self.mutations += 1
        finally:
            self.body.release_exclusive()

    # ------------------------------------------------------------------ thief
    def steal(self, k: int) -> StealResult:
        """Fig. 3b: claim ``k`` tail slots with ONE get-accumulate.

        Protocol: ``old = get_accumulate(-k)`` shifts the tail and returns the
        consistent pre-image.  With ``avail = old_tail - old_head``:

        * ``avail <= 0``  -> nothing to steal; full correction ``+k``.
        * ``avail <  k``  -> partial; occasional correction ``+(k - avail)``
                             (the dashed Atomic Accumulate of Fig. 3b).
        * ``avail >= k``  -> clean steal, no extra round-trip.
        """
        if k <= 0:
            return StealResult([], k, 0, False)
        old = self.headtail.get_accumulate(-k)  # single atomic: shift tail
        head, tail = unpack(old)
        avail = tail - head
        if avail <= 0:
            self.headtail.accumulate(+k)  # full correction
            with self._telemetry_lock:
                self.corrections += 1
            return StealResult([], k, 0, True, head, tail)
        take = min(k, avail)
        corrected = False
        if take < k:  # occasional correction: give back the overdraft
            self.headtail.accumulate(+(k - take))
            corrected = True
            with self._telemetry_lock:
                self.corrections += 1
        # Transfer the payload [tail - take, tail) under a shared body lock —
        # the victim may keep popping at the head concurrently (Fig. 2b III).
        self.body.acquire_shared()
        try:
            stolen = [self._slots.pop(tail - take + off) for off in range(take)]
            self.mutations += 1
        finally:
            self.body.release_shared()
        with self._telemetry_lock:
            self.steals_suffered += 1
        return StealResult(stolen, k, take, corrected, head, tail)

    def steal_by_work(
        self, work_target: float, work_of, max_tasks: int,
        take_first: bool = False,
    ) -> StealResult:
        """Work-greedy theft (DESIGN.md §Work-weighted stealing): claim tail
        slots ONE Fig. 3b get-accumulate at a time, pricing each candidate
        with ``work_of(task)``, until the cumulative stolen work is nearest
        ``work_target``.

        Each candidate is *peeked* (an extra one-sided Get under the shared
        body lock) before it is claimed: a task whose work would overshoot
        the target by more than the remaining deficit is refused — a slow
        thief planning to take one light-task's worth must never ingest a
        heavy task 8x its fair share, which is exactly the failure mode of
        counting loot by head-count.  With homogeneous work (``work_of`` ≡ 1
        and an integer target) this takes exactly ``work_target`` tasks —
        the count-based degenerate case.

        ``take_first``: accept the first candidate even when it overshoots —
        an IDLE thief executing an approved plan must stay work-conserving
        (the victim is loaded, the thief has nothing; leaving the task to
        rot because its class is heavier than the victim's stale mean unit
        is a latency disaster under open arrivals).  Refusal still applies
        from the second candidate on.

        The returned ``StealResult`` synthesizes a single-op pre-image so
        ``observed_tail - observed_head - len(tasks)`` is the queue actually
        left behind, matching the contract of :meth:`steal`.

        Topology contract (DESIGN.md §Topology plane): each claim here is a
        separate protocol hop, so a PRICED plan (``StealPlan.delay`` > 0 —
        the thief paid for ONE batched transfer of ``amount`` tasks) must
        not use this path; its call sites route priced loot through the
        single batched :meth:`steal` instead of k separately-priced hops.
        """
        taken: list = []
        cum = 0.0
        corrected = False
        claimed_any = False
        left_after = 0
        while len(taken) < max_tasks:
            nxt = self.peek_tail()
            if nxt is None:
                break
            w = max(float(work_of(nxt)), 0.0)
            if cum + w - work_target > work_target - cum + 1e-12 and not (
                take_first and not taken
            ):
                break  # overshoot beyond the deficit: worse than stopping
            r = self.steal(1)
            corrected |= r.corrected
            claimed_any = True
            left_after = max(r.observed_tail - r.observed_head, 0) - len(r.tasks)
            if not r.tasks:
                break
            task = r.tasks[0]  # may differ from the peek under thief races
            taken.append(task)
            cum += max(float(work_of(task)), 0.0)
        got = len(taken)
        if not claimed_any:
            head, tail = self.snapshot()
            return StealResult([], 0, 0, False, head, tail)
        left_after = max(left_after, 0)
        return StealResult(
            taken, max_tasks, got, corrected, 0, left_after + got
        )

    # ------------------------------------------------------------- inspection
    def peek_tail(self):
        """One-sided read of the task a thief would claim next (the slot at
        ``tail - 1``) WITHOUT claiming it — the pricing Get of
        :meth:`steal_by_work`.  Returns None when the deque is empty or the
        slot was concurrently claimed; purely advisory (a racing thief may
        take the peeked slot first)."""
        self.body.acquire_shared()
        try:
            head, tail = unpack(self.headtail.load())
            if tail <= head:
                return None
            missing = object()
            task = self._slots.get(tail - 1, missing)
            return None if task is missing else task
        finally:
            self.body.release_shared()

    def snapshot_tasks(self) -> list:
        """Best-effort copy of the queued payloads in ``[head, tail)``.

        Owner-side accounting read for the work-weighted information vector
        (the owner prices its own queue composition — DESIGN.md
        §Work-weighted stealing).  Taken under a shared body lock; a
        concurrent thief may have claimed tail slots already, so missing
        slots are skipped — the estimate self-corrects at the next publish.
        """
        self.body.acquire_shared()
        try:
            head, tail = unpack(self.headtail.load())
            missing = object()
            out = []
            for k in range(head, tail):
                task = self._slots.get(k, missing)
                if task is not missing:
                    out.append(task)
            return out
        finally:
            self.body.release_shared()

    def __len__(self) -> int:
        head, tail = unpack(self.headtail.load())
        return max(tail - head, 0)

    def snapshot(self) -> tuple[int, int]:
        return unpack(self.headtail.load())

    def _note_overdraft(self) -> None:
        # Paper: "the victim will detect the stolen tasks when checking the own
        # head and tail, verifying tail < head and ... classify its deque as
        # empty."  Nothing to fix — thief corrections restore the invariant.
        pass
