"""Network topology: transfer-cost model for pricing steals (DESIGN.md
§Topology plane).

Both planes priced a steal as if moving loot were free — victim selection
(Eq. 5, and the PR-4 work-weighted overlay) maximizes work-gained with
zero transfer cost, so at scale a thief happily strips a victim three
hops away over an equally-loaded neighbour.  A :class:`Topology` maps a
directed worker pair to the cost, in seconds, of moving ``ntasks`` tasks
across the link:

    cost(src, dst, ntasks) = latency(src, dst) + ntasks · per_task(src, dst)

with ``cost(i, i, ·) = 0`` (loot never leaves the node).  The scheduler
consumes this through one hook — ``PolicyView.transfer_cost(j, ntasks)``
— threaded from here through victim selection (distance-penalized
weights), plan pricing (net-negative steals refused), and the loot path
(the whole batch moves as ONE priced transfer; the plan's ``delay``
carries the price, so the threaded pool clock-paces it and the simulator
lands the loot ``cost`` virtual seconds later, overlapped with thief
compute).

``contention`` is a simple scalar knob consumed by the SIMULATOR only:
after a transfer starts on a directed link, the link stays busy for
``cost · contention`` seconds and later transfers on the same link queue
behind it (0 = infinite parallel capacity, 1 = full serialization).
The threaded plane and plan-time pricing always use the uncontended
cost — see the honest caveat in DESIGN.md §Topology plane.

``topology=None`` everywhere means "no network model": the scheduler is
bit-for-bit the zero-cost scheduler.  A link the model prices at 0.0 is
likewise charged the plane's DEFAULT transport cost (the simulator's
``steal_latency``/``steal_per_task``), not zero — so the all-zero
topology is also bit-for-bit the no-model scheduler, which is what the
conformance property in ``tests/test_topology.py`` pins.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

__all__ = ["Topology", "parse_topology"]


def _as_cell_fn(cells) -> Callable[[int], int]:
    """Normalize a cell description into ``worker -> cell id`` (-1 = unknown).

    Accepts a ``CellMap`` (anything with ``cell_of``), a callable, or an
    explicit per-worker sequence of cell ids.  Unknown workers (elastic
    joiners beyond what the description covers) map to -1, which the
    two-level cost model prices as CROSS-cell — the conservative default
    for a worker whose placement the model hasn't been told about.
    """
    if hasattr(cells, "cell_of"):
        cmap = cells

        def fn(g: int) -> int:
            try:
                return int(cmap.cell_of(int(g)))
            except (KeyError, IndexError, ValueError):
                return -1

        return fn
    if callable(cells):
        inner = cells

        def fn(g: int) -> int:
            try:
                return int(inner(int(g)))
            except (KeyError, IndexError, ValueError):
                return -1

        return fn
    table = [int(c) for c in cells]

    def fn(g: int) -> int:
        return table[g] if 0 <= g < len(table) else -1

    return fn


class Topology:
    """Directed transfer-cost model over worker pairs.

    ``latency``/``per_task`` are ``(src, dst) -> seconds`` callables; use
    the builders (:meth:`uniform`, :meth:`two_level`, :meth:`fat_tree`,
    :meth:`from_matrix`) rather than constructing directly.  The model
    must accept ANY non-negative worker id — elastic pools grow past the
    boot membership, and each builder documents its out-of-range rule.
    """

    __slots__ = ("_latency", "_per_task", "contention", "name")

    def __init__(
        self,
        latency: Callable[[int, int], float],
        per_task: Callable[[int, int], float],
        *,
        contention: float = 0.0,
        name: str = "custom",
    ) -> None:
        if not (contention >= 0.0 and math.isfinite(contention)):
            raise ValueError("contention must be finite and >= 0")
        self._latency = latency
        self._per_task = per_task
        self.contention = float(contention)
        self.name = name

    # ------------------------------------------------------------------ cost
    def cost(self, src: int, dst: int, ntasks: int = 1) -> float:
        """Seconds to move ``ntasks`` tasks from ``src`` to ``dst``
        (uncontended).  Zero for a local move."""
        if src == dst:
            return 0.0
        lat = float(self._latency(src, dst))
        per = float(self._per_task(src, dst))
        return max(lat, 0.0) + max(int(ntasks), 0) * max(per, 0.0)

    def add_per_task(self, extra: float, name: str | None = None) -> "Topology":
        """A new topology with ``extra`` seconds folded into every remote
        per-task cost — how ``ServePool`` prices per-request migration
        (warm-state loss rides the same hook as the network)."""
        if not (extra >= 0.0 and math.isfinite(extra)):
            raise ValueError("extra per-task cost must be finite and >= 0")
        base = self._per_task
        return Topology(
            self._latency,
            lambda s, d: float(base(s, d)) + extra,
            contention=self.contention,
            name=name or f"{self.name}+migration",
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Topology({self.name}, contention={self.contention})"

    # -------------------------------------------------------------- builders
    @classmethod
    def uniform(
        cls,
        latency: float = 0.0,
        per_task: float = 0.0,
        *,
        contention: float = 0.0,
    ) -> "Topology":
        """Every distinct pair costs the same — a flat switch.  Any worker
        id is valid, so elastic growth needs no special casing."""
        return cls(
            lambda s, d: latency,
            lambda s, d: per_task,
            contention=contention,
            name="uniform",
        )

    @classmethod
    def two_level(
        cls,
        cells,
        *,
        intra_latency: float = 0.0,
        intra_per_task: float = 0.0,
        cross_latency: float = 0.0,
        cross_per_task: float = 0.0,
        contention: float = 0.0,
    ) -> "Topology":
        """Two tiers matching the PR-6 hierarchy: cheap intra-cell links,
        expensive cross-cell links.  ``cells`` is a ``CellMap``, a
        ``worker -> cell`` callable, or an explicit per-worker cell-id
        sequence; workers the description doesn't cover price as
        CROSS-cell (conservative for elastic joiners)."""
        cell_of = _as_cell_fn(cells)

        def same(s: int, d: int) -> bool:
            cs, cd = cell_of(s), cell_of(d)
            return cs >= 0 and cs == cd

        return cls(
            lambda s, d: intra_latency if same(s, d) else cross_latency,
            lambda s, d: intra_per_task if same(s, d) else cross_per_task,
            contention=contention,
            name="two_level",
        )

    @classmethod
    def fat_tree(
        cls,
        k: int,
        *,
        hop_latency: float = 0.0,
        hop_per_task: float = 0.0,
        contention: float = 0.0,
    ) -> "Topology":
        """k-ary fat-tree (k³/4 hosts): cost scales with the standard hop
        count — 2 hops within an edge group (k/2 hosts), 4 within a pod
        (k²/4 hosts), 6 across pods.  Worker ids beyond k³/4 wrap modulo
        the host count (elastic joiners reuse physical slots)."""
        if k < 2 or k % 2:
            raise ValueError("fat_tree needs an even k >= 2")
        half = k // 2
        per_pod = half * half
        hosts = per_pod * k

        def hops(s: int, d: int) -> int:
            s, d = s % hosts, d % hosts
            if s == d:
                return 0
            if s // half == d // half:
                return 2  # same edge switch
            if s // per_pod == d // per_pod:
                return 4  # same pod, via aggregation
            return 6  # via core

        return cls(
            lambda s, d: hops(s, d) * hop_latency,
            lambda s, d: hops(s, d) * hop_per_task,
            contention=contention,
            name=f"fat_tree(k={k})",
        )

    @classmethod
    def from_matrix(
        cls,
        latency: Sequence[Sequence[float]] | np.ndarray,
        per_task: Sequence[Sequence[float]] | np.ndarray | None = None,
        *,
        contention: float = 0.0,
    ) -> "Topology":
        """Explicit (P, P) cost matrices — measured or synthesized.  A
        worker beyond the matrix prices at the matrix MAXIMUM (an
        unmodelled joiner is assumed far)."""
        lat = np.asarray(latency, dtype=np.float64)
        if lat.ndim != 2 or lat.shape[0] != lat.shape[1]:
            raise ValueError("latency must be a square (P, P) matrix")
        per = (
            np.zeros_like(lat)
            if per_task is None
            else np.asarray(per_task, dtype=np.float64)
        )
        if per.shape != lat.shape:
            raise ValueError("per_task must match the latency matrix shape")
        p = lat.shape[0]
        lat_far = float(lat.max()) if p else 0.0
        per_far = float(per.max()) if p else 0.0

        def pick(m: np.ndarray, far: float, s: int, d: int) -> float:
            if 0 <= s < p and 0 <= d < p:
                return float(m[s, d])
            return far

        return cls(
            lambda s, d: pick(lat, lat_far, s, d),
            lambda s, d: pick(per, per_far, s, d),
            contention=contention,
            name="matrix",
        )


def parse_topology(spec: str | None, num_workers: int) -> Topology | None:
    """CLI string -> Topology (``launch.serve --topology``).

    Forms (all costs in seconds): ``none``; ``uniform:LAT:PER_TASK``;
    ``two-level:K:INTRA:CROSS`` (K equal contiguous cells, latency-only
    tiers); ``fat-tree:K:HOP`` (per-hop latency).
    """
    if spec is None or spec in ("", "none"):
        return None
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind == "uniform":
            lat = float(parts[1]) if len(parts) > 1 else 0.0
            per = float(parts[2]) if len(parts) > 2 else 0.0
            return Topology.uniform(lat, per)
        if kind in ("two-level", "two_level"):
            k = int(parts[1]) if len(parts) > 1 else max(1, round(math.sqrt(num_workers)))
            intra = float(parts[2]) if len(parts) > 2 else 0.0
            cross = float(parts[3]) if len(parts) > 3 else 10 * intra
            size = max(1, -(-num_workers // max(k, 1)))  # ceil
            return Topology.two_level(
                lambda g: g // size, intra_latency=intra, cross_latency=cross
            )
        if kind in ("fat-tree", "fat_tree"):
            k = int(parts[1]) if len(parts) > 1 else 4
            hop = float(parts[2]) if len(parts) > 2 else 0.0
            return Topology.fat_tree(k, hop_latency=hop)
    except (ValueError, IndexError) as e:
        raise ValueError(f"bad --topology spec {spec!r}") from e
    raise ValueError(f"unknown --topology kind {kind!r}")
