"""Limited information communication over a bidirectional ring (paper §2.1).

Every process ``i`` owns an *information vector* holding, for each process
``j`` in its radius-R subsystem (Eq. 1: ``P_sub = 2R+1``), the pair
``(n_j, t_j)`` — total task count and mean task runtime — plus a freshness
flag (Table 1).

The paper's key trick is a **write partition** that makes one-sided ``Put``s
race-free without locks: in p_i's vector, positions ``i-R..i-1`` are written
only by the left neighbour p_{i-1}, position ``i`` only by p_i itself, and
positions ``i+1..i+R`` only by the right neighbour p_{i+1}.  Information about
process j therefore flows hop-by-hop away from j in both ring directions,
with exactly one writer per (vector, cell).

TPU/JAX adaptation: this module is the *host control plane* version — numpy
arrays in shared memory stand in for MPI RMA windows, and the single-writer
partition carries over verbatim (so no locks are needed here either, exactly
as in the paper).  The *device data plane* version — two ``lax.ppermute``s per
round — lives in ``repro.core.device_sched``.

Freshness flags are realised as **per-cell version counters** plus a private
``last_sent`` watermark per direction: ``dirty(cell, dir) == version[cell] >
last_sent[dir][cell]``.  This is equivalent to Table 1's boolean flags but
immune to the set/clear race a boolean would have with two writers, and it
gives staleness telemetry for free.
"""

from __future__ import annotations

import threading

import numpy as np

from .steal import neighborhood

__all__ = ["RingInfo", "CellMap", "CellDigest", "DigestBoard", "CellBoard"]


class RingInfo:
    """Shared information board for P processes with propagation radius R.

    Elastic membership (DESIGN.md §Elasticity): ``grow`` remaps the board to
    a larger ring.  New members start with ``n = 0, t = NaN, version = 0`` —
    exactly the boot state — so every thief's §2.2.1 preemptive wall-time
    estimate covers them until their first report propagates.  ``_epoch``
    serialises the whole-board swap against cell writes; it is NOT a cell
    lock (the §2.1 single-writer partition still makes individual Puts
    race-free) but an epoch guard so a writer never lands on a half-swapped
    board and per-cell versions stay monotone across growth.
    """

    def __init__(
        self, num_procs: int, radius: int, num_classes: int = 1
    ) -> None:
        if num_procs < 1:
            raise ValueError("num_procs must be >= 1")
        if num_classes < 1:
            raise ValueError("num_classes must be >= 1")
        self.P = num_procs
        self.R = int(max(0, min(radius, num_procs // 2)))
        self.C = num_classes
        # board[i, j] = what process i currently believes about process j.
        self.n = np.zeros((self.P, self.P), dtype=np.float64)
        self.t = np.full((self.P, self.P), np.nan, dtype=np.float64)
        # Work-weighted extension (DESIGN.md §Work-weighted stealing): each
        # cell also carries the per-class queue counts nc[c] and per-class
        # EWMA runtime estimates t̂[c] of the subject process.  The payload
        # rides the SAME per-cell version counters — one Put moves the whole
        # cell, so (n, t, nc, tc) stay mutually consistent per §2.1 writer.
        self.nc = np.zeros((self.P, self.P, self.C), dtype=np.float64)
        self.tc = np.full((self.P, self.P, self.C), np.nan, dtype=np.float64)
        # Straggler plane (DESIGN.md §Straggler plane): the subject's
        # self-reported limping flag.  One boolean riding the SAME per-cell
        # version counters — it moves with (n, t) in one Put, so a thief
        # never sees a re-priced t without the flag that explains it.
        self.limp = np.zeros((self.P, self.P), dtype=bool)
        self.version = np.zeros((self.P, self.P), dtype=np.int64)
        # last_sent[d][i, j]: newest version of cell j that i pushed toward
        # direction d (0 = to left neighbour i-1, 1 = to right neighbour i+1).
        self.last_sent = np.zeros((2, self.P, self.P), dtype=np.int64)
        self.puts = 0  # telemetry: number of cell-level Put operations
        self.rounds = 0
        # Reentrant so communicate() can hold it ONCE around its whole send
        # round (up to 2R cell Puts) instead of paying an acquire per cell.
        self._epoch = threading.RLock()

    # -------------------------------------------------------------- elasticity
    def grow(self, num_procs: int, radius: int | None = None) -> None:
        """Remap the board to ``num_procs`` ring positions (scale-out).

        Existing cells (values, versions, send watermarks) carry over
        verbatim; the new positions join as unreported members (n=0, t=NaN,
        version=0).  Shrinking is not supported — leavers are tombstoned by
        the substrate, never removed, so ring indices stay stable.
        """
        if num_procs < self.P:
            raise ValueError(
                f"cannot shrink the ring ({self.P} -> {num_procs}); "
                "retired members keep their positions as tombstones"
            )
        with self._epoch:
            new_r = self.R if radius is None else radius
            new_r = int(max(0, min(new_r, num_procs // 2)))
            if num_procs == self.P:
                self.R = new_r
                return
            old = self.P
            n = np.zeros((num_procs, num_procs), dtype=np.float64)
            t = np.full((num_procs, num_procs), np.nan, dtype=np.float64)
            nc = np.zeros((num_procs, num_procs, self.C), dtype=np.float64)
            tc = np.full((num_procs, num_procs, self.C), np.nan, dtype=np.float64)
            limp = np.zeros((num_procs, num_procs), dtype=bool)
            version = np.zeros((num_procs, num_procs), dtype=np.int64)
            last_sent = np.zeros((2, num_procs, num_procs), dtype=np.int64)
            n[:old, :old] = self.n
            t[:old, :old] = self.t
            nc[:old, :old] = self.nc
            tc[:old, :old] = self.tc
            limp[:old, :old] = self.limp
            version[:old, :old] = self.version
            last_sent[:, :old, :old] = self.last_sent
            self.n, self.t = n, t
            self.nc, self.tc = nc, tc
            self.limp = limp
            self.version, self.last_sent = version, last_sent
            self.P, self.R = num_procs, new_r

    def reset_member(self, k: int) -> None:
        """A replacement took over tombstoned ring position ``k``: every
        process's cell about k returns to the unreported boot state (n=0,
        t=NaN) so §2.2.1 preemptive estimates price the newcomer, not the
        ghost it replaced.  Versions BUMP (never reset) — observers stay
        monotone and the reset propagates like any other news."""
        with self._epoch:
            self.n[:, k] = 0.0
            self.t[:, k] = np.nan
            self.nc[:, k, :] = 0.0
            self.tc[:, k, :] = np.nan
            self.limp[:, k] = False
            self.version[:, k] += 1

    # ------------------------------------------------------------ local write
    def update_local(
        self,
        i: int,
        n_i: float,
        t_i: float,
        nc_i: np.ndarray | None = None,
        tc_i: np.ndarray | None = None,
        limp_i: bool = False,
    ) -> None:
        """Alg. 1 lines 2/11: p_i refreshes its own cell (Table 1 row 1).

        ``nc_i``/``tc_i``: optional per-class queue counts and EWMA runtime
        estimates (work-weighted mode); they share the cell's version, so a
        class-profile change alone is enough to mark the cell dirty.
        ``limp_i``: the owner-side limp-detector verdict (DESIGN.md
        §Straggler plane) — a flag flip alone also dirties the cell.
        """
        with self._epoch:
            changed = (self.n[i, i] != n_i) or not _feq(self.t[i, i], t_i)
            if bool(self.limp[i, i]) != limp_i:
                self.limp[i, i] = limp_i
                changed = True
            if nc_i is not None and not np.array_equal(self.nc[i, i], nc_i):
                self.nc[i, i] = nc_i
                changed = True
            if tc_i is not None and not np.array_equal(
                self.tc[i, i], tc_i, equal_nan=True
            ):
                self.tc[i, i] = tc_i
                changed = True
            if changed:
                self.n[i, i] = n_i
                self.t[i, i] = t_i
                self.version[i, i] += 1

    def record_remote(
        self,
        i: int,
        j: int,
        n_j: float,
        t_j: float,
        nc_j: np.ndarray | None = None,
    ) -> None:
        """Thief-side knowledge injection (Table 1 rows 2-3).

        After (attempting) a steal, the thief p_i learned the victim's new
        queue state first-hand (it moved the tail itself), so it writes the
        victim's cell in its OWN vector and bumps the version so the news
        propagates outward from the thief.  ``nc_j``: the victim's corrected
        per-class queue profile (the thief saw the classes of the loot it
        took); the victim's t̂[c] estimates are NOT the thief's to correct.
        """
        with self._epoch:
            self.n[i, j] = n_j
            if t_j == t_j:  # not NaN
                self.t[i, j] = t_j
            if nc_j is not None:
                self.nc[i, j] = nc_j
            self.version[i, j] += 1

    # ------------------------------------------------------- ring propagation
    def communicate(self, i: int, can_send=None) -> int:
        """Alg. 1 line 13: push dirty cells to both ring neighbours.

        p_i sends cells about indices ``j >= i`` to its LEFT neighbour (which
        stores them in its upper window) and cells about ``j <= i`` to its
        RIGHT neighbour — the write partition of §2.1.  Only cells whose
        version advanced since the previous send to that direction move
        (Table 1: "Only new information is exchanged").

        ``can_send(neighbour) -> bool`` (fault plane, DESIGN.md §Fault
        fabric): when given, a whole direction is skipped if the neighbour
        is unreachable — the watermark does NOT advance, so the cells are
        re-offered once the link heals.  ``can_send=None`` is exactly the
        ungated round.

        Returns the number of cells transmitted (0 = nothing dirty).
        """
        if self.P == 1 or self.R == 0:
            return 0
        sent = 0
        with self._epoch:  # one hold per round; inner Puts re-enter cheaply
            left = (i - 1) % self.P
            right = (i + 1) % self.P
            # Cells the LEFT neighbour may receive: positions j in left's
            # upper window, i.e. ring-distance(left -> j) in [1, R] going
            # right; those are exactly j = i .. i+R-1 (distance from i:
            # 0..R-1).
            if can_send is None or can_send(left):
                for off in range(0, self.R):
                    j = (i + off) % self.P
                    sent += self._put(i, left, j, direction=0)
            # Cells the RIGHT neighbour may receive: j = i-R+1 .. i.
            if can_send is None or can_send(right):
                for off in range(0, self.R):
                    j = (i - off) % self.P
                    sent += self._put(i, right, j, direction=1)
            self.rounds += 1
        return sent

    def resync(self, i: int) -> None:
        """Partition heal (DESIGN.md §Fault fabric): forget everything ``i``
        believes it already delivered.  A neighbour on the far side of a cut
        may hold copies frozen at the cut instant, yet ``last_sent`` says
        "already sent" — without this reset the stale cells would never be
        re-offered.  Versions are untouched, so receivers stay monotone: a
        re-Put of a version they already hold is a no-op."""
        with self._epoch:
            self.last_sent[:, i, :] = 0

    def _put(self, src: int, dst: int, j: int, direction: int) -> int:
        with self._epoch:  # epoch guard only — see class docstring
            ver = self.version[src, j]
            if ver <= self.last_sent[direction, src, j]:
                return 0  # flag is false: nothing new to send
            self.last_sent[direction, src, j] = ver
            # One-sided Put into dst's window.  Single-writer per (dst, j)
            # cell by the §2.1 partition, hence no cell lock.  Keep
            # monotonicity: a cell only moves forward in version (defensive;
            # partition already ensures it).
            if ver > self.version[dst, j]:
                self.n[dst, j] = self.n[src, j]
                self.t[dst, j] = self.t[src, j]
                self.nc[dst, j] = self.nc[src, j]
                self.tc[dst, j] = self.tc[src, j]
                self.limp[dst, j] = self.limp[src, j]
                self.version[dst, j] = ver
            self.puts += 1
            return 1

    # -------------------------------------------------------------- inspection
    def view(
        self, i: int, default_t: float | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(n, t) rows as seen by process i, with unknown ``t`` cells filled.

        Fallback order for a NaN cell: ``default_t`` when the caller passes
        one (e.g. the preemptive wall-time estimate of §2.2.1), else the
        MEAN of the t's process i actually knows — the subsystem-mean prior
        says "an unreported neighbour is probably an average one", which
        keeps Eq. 5's harmonic sum on the right scale.  Only when process i
        knows NOTHING at all does 1.0 remain: with every cell equal, the
        fair share degenerates to a pure task-count split, so the actual
        constant cancels out.  (The old fallback of a flat 1.0 s whenever
        the own cell was still NaN poisoned Eq. 5 for sub-millisecond
        tasks: one fake 1 s neighbour dwarfs the real harmonic sum.)
        """
        n, t, _raw, _window = self.view_window(i, default_t)
        return n, t

    def view_window(
        self, i: int, default_t: float | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[int]]:
        """``view(i)`` plus the raw-t row and radius window, all from ONE
        board epoch — a concurrent ``grow`` can never hand a caller a window
        sized for a bigger ring than the rows it just copied."""
        n, t, raw_t, window, _nc, _tc = self.view_window_classes(i, default_t)
        return n, t, raw_t, window

    def view_window_classes(
        self, i: int, default_t: float | None = None
    ) -> tuple[
        np.ndarray, np.ndarray, np.ndarray, list[int], np.ndarray, np.ndarray
    ]:
        """``view_window(i)`` plus the (P, C) per-class rows — queue counts
        ``nc`` and EWMA runtime estimates ``tc`` (NaN = unreported) — all
        copied under the same board epoch so the work-weighted overlay can
        never mix ring sizes with the scalar rows."""
        n, t, raw_t, window, nc, tc, _limp = self.view_window_all(i, default_t)
        return n, t, raw_t, window, nc, tc

    def view_window_all(
        self, i: int, default_t: float | None = None
    ) -> tuple[
        np.ndarray, np.ndarray, np.ndarray, list[int],
        np.ndarray, np.ndarray, np.ndarray,
    ]:
        """``view_window_classes(i)`` plus the delayed limp-flag row
        (DESIGN.md §Straggler plane), under the same board epoch."""
        with self._epoch:
            n = self.n[i].copy()
            raw_t = self.t[i].copy()
            nc = self.nc[i].copy()
            tc = self.tc[i].copy()
            limp = self.limp[i].copy()
            window = neighborhood(i, self.P, self.R)
        t = raw_t.copy()
        mask = np.isnan(t)
        if mask.any():
            if default_t is not None:
                fill = default_t
            else:
                known = t[~mask]
                fill = float(known.mean()) if known.size else 1.0
            t[mask] = fill
        return n, t, raw_t, window, nc, tc, limp

    def window(self, i: int) -> list[int]:
        return neighborhood(i, self.P, self.R)

    def belief_t(self, i: int, j: int) -> float:
        """What i currently believes about j's mean task time (raw cell)."""
        return float(self.t[i, j])

    def belief_nc(self, i: int, j: int) -> np.ndarray | None:
        """i's current belief about j's per-class queue profile (the row the
        Fig. 3b loot correction subtracts from)."""
        return self.nc[i, j]

    def peer_raw_t(self, i: int) -> list[tuple[int, float]]:
        """(peer id, raw believed t) over i's window, excluding i — the
        limp detector's boot-time peer-median reference (NaN = unreported).
        On a :class:`CellBoard` the same call returns GLOBAL ids scoped to
        i's cell, so callers need not know which board they hold."""
        row = self.t[i]
        return [(j, float(row[j])) for j in self.window(i) if j != i]

    def staleness(self, truth_version: np.ndarray) -> np.ndarray:
        """How many versions behind each process's view is (telemetry)."""
        return truth_version[None, :] - self.version


def _feq(a: float, b: float) -> bool:
    if a != a and b != b:  # both NaN
        return True
    return a == b


# --------------------------------------------------------------------------- #
#                      two-level hierarchy (DESIGN.md §Hierarchy)              #
# --------------------------------------------------------------------------- #


class CellMap:
    """Global worker ids grouped into K cells, each cell a small local ring.

    The flat ring's O(P) per-boundary view is what tops out at production
    pool sizes; the hierarchy replaces it with K cells of ~ρ members, each
    running ordinary intra-cell A2WS on its own sub-board (O(ρ) views), plus
    a K-wide leader plane (:class:`DigestBoard`) for inter-cell balancing.

    Mapping invariants:

    * every global id maps to exactly one ``(cell, local slot)``;
    * local slots are APPEND-ONLY — a member that migrates away leaves a
      hole (``-1`` in ``members``) so every other member's slot, and hence
      its sub-board column, stays stable (the same tombstone-not-remove
      discipline the flat ring uses for dead workers);
    * cells are never added or removed after construction (K is the
      topology; joiners land in the smallest live cell).

    Readers are lock-free: ``members`` returns a copy taken under the lock,
    and ``cell_of``/``local_of`` are single atomic list reads.  Mutations
    (``assign``/``migrate``) serialise on the internal lock.
    """

    def __init__(
        self,
        num_workers: int,
        num_cells: int | None = None,
        cell_size: int | None = None,
        radius: int | None = None,
    ) -> None:
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if num_cells is None and cell_size is None:
            # Default topology: ~sqrt(P) cells — balances the O(ρ) intra-cell
            # view against the O(K) leader plane.
            num_cells = max(1, int(round(float(num_workers) ** 0.5)))
        if num_cells is None:
            num_cells = max(1, -(-num_workers // max(int(cell_size), 1)))
        num_cells = int(num_cells)
        if num_cells < 1:
            raise ValueError("num_cells must be >= 1")
        if num_cells > num_workers:
            num_cells = num_workers
        self.num_cells = num_cells
        #: explicit intra-cell Eq. 5 radius; None = full-cell window
        #: (ρ//2 — with ρ small the leader then digests its WHOLE cell)
        self.cell_radius = radius
        self._lock = threading.Lock()
        # Contiguous block split, like the flat static partition: cell k
        # gets ~P/K consecutive ids (locality-friendly when ids are ranks).
        self._members: list[list[int]] = [[] for _ in range(num_cells)]
        self._cell_of: list[int] = [0] * num_workers
        self._local_of: list[int] = [0] * num_workers
        base, rem = divmod(num_workers, num_cells)
        g = 0
        for c in range(num_cells):
            k = base + (1 if c < rem else 0)
            for _ in range(k):
                self._cell_of[g] = c
                self._local_of[g] = len(self._members[c])
                self._members[c].append(g)
                g += 1
        #: bumps on every assign/migrate — membership-change telemetry and
        #: the staleness hook for remapping property tests
        self.version = 0

    @property
    def num_workers(self) -> int:
        return len(self._cell_of)

    def cell_of(self, worker: int) -> int:
        return self._cell_of[worker]

    def local_of(self, worker: int) -> int:
        return self._local_of[worker]

    def locate(self, worker: int) -> tuple[int, int]:
        """Consistent ``(cell, local)`` pair under the lock — a concurrent
        ``migrate`` can never hand a caller the old cell with the new local
        slot (the torn read the two single-field getters would allow)."""
        with self._lock:
            return self._cell_of[worker], self._local_of[worker]

    def members(self, cell: int) -> list[int]:
        """Global ids by local slot (``-1`` = hole left by a migration)."""
        with self._lock:
            return list(self._members[cell])

    def slots(self, cell: int) -> int:
        return len(self._members[cell])

    def live_size(self, cell: int) -> int:
        with self._lock:
            return sum(1 for g in self._members[cell] if g >= 0)

    def radius_of(self, cell: int) -> int:
        """Intra-cell Eq. 5 radius: the explicit override, else the
        full-cell window (slots//2 — ``neighborhood`` then covers every
        slot, so the leader's digest aggregates its whole cell)."""
        m = max(len(self._members[cell]), 1)
        if self.cell_radius is not None:
            return int(max(0, min(self.cell_radius, m // 2)))
        return m // 2

    def assign(self, worker: int) -> int:
        """Home a NEW global id (elastic join) in the smallest live cell and
        return the cell.  Idempotent for already-mapped ids (a recycled
        tombstone slot keeps its cell — its sub-board column is reset by the
        substrate, not re-homed)."""
        with self._lock:
            if worker < len(self._cell_of):
                return self._cell_of[worker]
            if worker != len(self._cell_of):
                raise ValueError(
                    f"joins must be dense: expected id {len(self._cell_of)}, "
                    f"got {worker}"
                )
            sizes = [
                sum(1 for g in mem if g >= 0) for mem in self._members
            ]
            cell = int(min(range(self.num_cells), key=lambda c: sizes[c]))
            self._cell_of.append(cell)
            self._local_of.append(len(self._members[cell]))
            self._members[cell].append(worker)
            self.version += 1
            return cell

    def migrate(self, worker: int, new_cell: int) -> tuple[int, int]:
        """Re-home ``worker`` to ``new_cell`` (leader-level member
        migration).  The old slot becomes a hole; the worker gets a fresh
        slot appended to the new cell.  Returns ``(old_cell, new_local)``."""
        if not 0 <= new_cell < self.num_cells:
            raise ValueError(f"cell {new_cell} out of range 0..{self.num_cells - 1}")
        with self._lock:
            old_cell = self._cell_of[worker]
            if old_cell == new_cell:
                return old_cell, self._local_of[worker]
            self._members[old_cell][self._local_of[worker]] = -1
            new_local = len(self._members[new_cell])
            self._members[new_cell].append(worker)
            # Order matters for lock-free readers resolving (cell, local):
            # the new slot exists before the mapping flips to it.
            self._local_of[worker] = new_local
            self._cell_of[worker] = new_cell
            self.version += 1
            return old_cell, new_local


class CellDigest:
    """One cell's compact self-description on the leader plane: aggregate
    queued work-seconds, task count, live membership, optional per-class
    mix, and the richest member (the inter-cell steal target).

    ``leader`` is the publishing leader's GLOBAL worker id — the digest's
    cell-DISTANCE hint (DESIGN.md §Topology plane): a consuming leader can
    price the link to a cell through any :class:`~repro.core.topology.
    Topology` by measuring to its leader (or to ``top_worker`` when one is
    named), even before it knows anything else about that cell's layout.
    -1 = unpriced (digests published before the topology plane existed)."""

    __slots__ = (
        "cell", "time", "work", "tasks", "live", "top_worker", "top_queued",
        "top_work", "mix", "seq", "leader",
    )

    def __init__(
        self,
        cell: int,
        time: float,
        work: float,
        tasks: float,
        live: int,
        top_worker: int,
        top_queued: int,
        top_work: float = 0.0,
        mix: np.ndarray | None = None,
        seq: int = 0,
        leader: int = -1,
    ) -> None:
        self.cell = cell
        self.time = time
        self.work = work
        self.tasks = tasks
        self.live = live
        self.top_worker = top_worker
        self.top_queued = top_queued
        self.top_work = top_work
        self.mix = mix
        self.seq = seq
        self.leader = leader


class DigestBoard:
    """The K-wide leader ring: one digest slot per cell.

    Single writer per slot (only the cell's current leader publishes), so a
    publish is one atomic reference swap — the same §2.1 write-partition
    argument as the flat board, scaled down to K entries.  Readers see a
    consistent digest or an older one, never a torn write.  Transport delay
    on the leader plane is not modelled (K is small and digests are
    aggregates that age gracefully) — documented in DESIGN.md §Hierarchy.
    """

    def __init__(self, num_cells: int) -> None:
        self.slots: list[CellDigest | None] = [None] * num_cells
        self.publishes = 0  # telemetry (racy increment; indicative only)

    def publish(self, digest: CellDigest) -> None:
        prev = self.slots[digest.cell]
        digest.seq = (prev.seq + 1) if prev is not None else 1
        self.slots[digest.cell] = digest  # atomic reference swap
        self.publishes += 1

    def get(self, cell: int) -> CellDigest | None:
        return self.slots[cell]

    def peers(self, cell: int) -> list[CellDigest]:
        """Every other cell's latest digest (skips never-published slots)."""
        return [
            d for c, d in enumerate(self.slots) if c != cell and d is not None
        ]

    def reset(self) -> None:
        self.slots = [None] * len(self.slots)


class CellBoard:
    """K per-cell :class:`RingInfo` sub-boards behind GLOBAL-id addressing.

    The substrate keeps talking in global worker ids; this facade maps every
    call through the :class:`CellMap` to ``(cell, local)`` and the cell's
    own sub-board.  Each sub-board is an ordinary flat RingInfo over the
    cell's local slots — view, Eq. 5 radius, weighted overlay and limp
    re-pricing all run unchanged, just scoped to ρ members — which is the
    whole point: K=1 IS the flat scheduler (one sub-board of size P).

    Cross-cell writes (``record_remote`` after an inter-cell steal) are
    dropped: the victim's cell is not on the thief's board, and digests —
    not cells — carry inter-cell knowledge.
    """

    def __init__(self, cells: CellMap, num_classes: int = 1) -> None:
        self.cells = cells
        self.C = num_classes
        self.boards = [
            RingInfo(
                max(cells.slots(c), 1), cells.radius_of(c), num_classes
            )
            for c in range(cells.num_cells)
        ]
        self.digests = DigestBoard(cells.num_cells)
        self.dropped_remote = 0  # telemetry: cross-cell record_remote drops

    # ------------------------------------------------------------ delegation
    def _loc(self, worker: int) -> tuple["RingInfo", int]:
        c, loc = self.cells.locate(worker)
        return self.boards[c], loc

    @property
    def puts(self) -> int:
        return sum(b.puts for b in self.boards)

    @property
    def rounds(self) -> int:
        return sum(b.rounds for b in self.boards)

    def update_local(self, i: int, *a, **kw) -> None:
        board, loc = self._loc(i)
        board.update_local(loc, *a, **kw)

    def communicate(self, i: int, can_send=None) -> int:
        c, loc = self.cells.locate(i)
        board = self.boards[c]
        if can_send is None:
            return board.communicate(loc)
        # The gate speaks GLOBAL ids; the sub-board's neighbours are LOCAL
        # slots — translate through the member list (holes never receive).
        mem = self.cells.members(c)

        def _can(jl, _mem=mem, _cs=can_send):
            g = _mem[jl] if jl < len(_mem) else -1
            return g >= 0 and _cs(g)

        return board.communicate(loc, can_send=_can)

    def resync(self, i: int) -> None:
        """Partition heal: reset ``i``'s send watermarks on its sub-board
        (see :meth:`RingInfo.resync`).  Digests are NOT resynced — they are
        re-published wholesale every leader round anyway."""
        board, loc = self._loc(i)
        board.resync(loc)

    def record_remote(self, i: int, j: int, *a, **kw) -> None:
        ci, li = self.cells.locate(i)
        cj, lj = self.cells.locate(j)
        if ci != cj:
            self.dropped_remote += 1  # inter-cell: no shared board
            return
        self.boards[ci].record_remote(li, lj, *a, **kw)

    def view_window_all(self, i: int, default_t: float | None = None):
        board, loc = self._loc(i)
        return board.view_window_all(loc, default_t)

    def window(self, i: int) -> list[int]:
        """GLOBAL ids of i's intra-cell window (holes dropped)."""
        c, loc = self.cells.locate(i)
        board = self.boards[c]
        mem = self.cells.members(c)
        out = []
        for jl in board.window(loc):
            if jl < len(mem) and mem[jl] >= 0:
                out.append(mem[jl])
        return out

    def belief_t(self, i: int, j: int) -> float:
        """What i currently believes about j's mean task time (NaN when j is
        outside i's cell — inter-cell victims are priced by digest)."""
        ci, li = self.cells.locate(i)
        cj, lj = self.cells.locate(j)
        if ci != cj:
            return float("nan")
        return float(self.boards[ci].t[li, lj])

    def belief_nc(self, i: int, j: int) -> np.ndarray | None:
        """i's believed per-class queue profile of j (None when j lives in
        another cell — there is no shared board row to correct)."""
        ci, li = self.cells.locate(i)
        cj, lj = self.cells.locate(j)
        if ci != cj:
            return None
        return self.boards[ci].nc[li, lj]

    def peer_raw_t(self, i: int) -> list[tuple[int, float]]:
        """(GLOBAL peer id, raw believed t) over i's intra-cell window — the
        limp detector's peer-median reference, scoped to i's cell."""
        c, loc = self.cells.locate(i)
        board = self.boards[c]
        mem = self.cells.members(c)
        row = board.t[loc]
        out = []
        for jl in board.window(loc):
            if jl != loc and jl < len(mem) and mem[jl] >= 0:
                out.append((mem[jl], float(row[jl])))
        return out

    # ------------------------------------------------------------ elasticity
    def ensure(self, worker: int) -> None:
        """Grow ``worker``'s cell sub-board to cover its local slot (elastic
        join / migration landing).  The new column joins unreported —
        preemptive §2.2.1 estimates cover it exactly like boot."""
        c = self.cells.cell_of(worker)
        need = self.cells.slots(c)
        if self.boards[c].P < need:
            self.boards[c].grow(need, self.cells.radius_of(c))

    def reset_member(self, worker: int) -> None:
        board, loc = self._loc(worker)
        board.reset_member(loc)

    def migrate(self, worker: int, new_cell: int) -> None:
        """Board-side half of a member migration: re-home the mapping, then
        grow the receiving sub-board to cover the fresh slot.  The old
        cell's column stays as a hole (stable slots), masked out of views by
        the substrate exactly like a tombstone."""
        self.cells.migrate(worker, new_cell)
        self.ensure(worker)
