"""A2WS — Adaptive Asynchronous Work-Stealing (the paper's contribution).

The modules here, but for ``device_sched``, are verbatim copies of their
namesakes in ``src/repro/core`` (a test holds them byte-identical): pure
Python and numpy, so the port keeps its own copy instead of importing the JAX
package.  ``device_sched`` is the port of the reference's jitted SPMD
scheduler to torch tensors with a leading worker dimension.

Layers:
  steal        Eqs. 2-10 (steal rate, γ-rounding, victim selection)
  info_ring    radius-R bidirectional ring information vector (§2.1)
  deque        packed head/tail asynchronous-theft deque (§2.3, Fig. 2/3b)
  policy       pluggable SchedPolicy layer (A2WS, CTWS, LW, random-WS)
  limp         straggler plane: slowdown fault injection + limp detection
  topology     network-cost model pricing steals
  netfault     network-fault plane for the steal fabric
  a2ws         policy-parametric threaded WorkerPool substrate (Algorithm 1)
  baselines    LW (leader-workers) and CTWS (cyclic token) policy shims
  simulator    discrete-event virtual-time plane driving the same policies
  trace        bursty diurnal arrival traces for the simulator
  device_sched the scheduler vectorized over workers on one device (card or CPU)
"""

from .a2ws import A2WSRuntime, RunStats, WorkerPool, partition_tasks
from .baselines import CTWSRuntime, LWRuntime
from .deque import AtomicInt64, StealResult, TaskDeque
from .info_ring import CellBoard, CellDigest, CellMap, DigestBoard, RingInfo
from .limp import LimpConfig, LimpState, SlowdownEvent, SlowdownSchedule
from .policy import (
    POLICIES,
    A2WSPolicy,
    CTWSPolicy,
    HierarchicalA2WSPolicy,
    LWPolicy,
    PolicyView,
    RandomWSPolicy,
    SchedPolicy,
    StealPlan,
    make_policy,
)
from .simulator import SimConfig, SimResult, simulate, table2_speeds
from .steal import (
    StealDecision,
    gamma,
    ideal_runtime,
    neighborhood,
    pair_steal_rate,
    plan_steal,
    round_steal_rate,
    select_victim,
    steal_rate,
    steal_rate_radius,
    victim_weights,
)

__all__ = [
    "A2WSRuntime",
    "WorkerPool",
    "RunStats",
    "partition_tasks",
    "CTWSRuntime",
    "LWRuntime",
    "SchedPolicy",
    "StealPlan",
    "PolicyView",
    "A2WSPolicy",
    "CTWSPolicy",
    "HierarchicalA2WSPolicy",
    "LWPolicy",
    "RandomWSPolicy",
    "POLICIES",
    "make_policy",
    "AtomicInt64",
    "StealResult",
    "TaskDeque",
    "RingInfo",
    "CellMap",
    "CellBoard",
    "CellDigest",
    "DigestBoard",
    "LimpConfig",
    "LimpState",
    "SlowdownEvent",
    "SlowdownSchedule",
    "SimConfig",
    "SimResult",
    "simulate",
    "table2_speeds",
    "StealDecision",
    "gamma",
    "ideal_runtime",
    "neighborhood",
    "pair_steal_rate",
    "plan_steal",
    "round_steal_rate",
    "select_victim",
    "steal_rate",
    "steal_rate_radius",
    "victim_weights",
]
