"""Serving: prefill/decode steps on one device + the host-side pool, as in
``repro/serve/engine.py``.

Device plane
------------
``jit_prefill_step``/``jit_decode_step`` keep the reference's names and
return callables over ``lm.prefill``/``lm.decode_step``.  PyTorch runs them
eagerly; there is nothing to trace.  Given a context with a mesh, their
"jit" is the reference's placement of inputs and outputs: parameters,
batch and caches are laid out (as DTensors) by the sharding rules and
``cache_pspecs`` on the way in, and the caches leave in that layout.
``abstract_caches`` gives the cache tree as ``meta`` tensors: K/V for GQA
blocks, the compressed ``c`` and rope key for MLA, and for an enc-dec
model's ``xdec`` blocks the pair of self-attention K/V and encoder-memory
K/V.

Host plane
----------
``ServePool`` is a **continuous-batching server** on the open-arrival
``WorkerPool`` substrate (DESIGN.md §Open-arrival, §Policy layer): requests
stream in through ``submit()`` while the pool is live, each replica is a
worker whose deque holds queued requests, and the scheduling policy
(``policy=`` — A2WS by default, or CTWS/LW/random for head-to-head baseline
serving) moves queued requests between replicas mid-flight.  Everything from
``request_size`` to the end of this file is the reference's code byte for
byte (it uses no JAX); only the imports above it differ.  On a card, give
each replica's ``generate`` its own CUDA stream and let it return only once
that stream is done, so the pool prices service times, not launch times.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.core.a2ws import PoolCollapsed, RunStats, WorkerPool
from repro_torch.core.deque import SLO_BATCH, SLO_LATENCY, SLO_NAMES
from repro_torch.core.limp import LimpConfig, SlowdownSchedule
from repro_torch.core.netfault import NetFaultSchedule
from repro_torch.core.policy import SchedPolicy
from repro_torch.core.topology import Topology
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (
    NamedSharding,
    ParallelContext,
    distribute_tree,
    map_specs,
    serve_context,
    shardings_for,
)
from repro_torch.train.step import batch_shardings

__all__ = [
    "abstract_caches",
    "cache_pspecs",
    "cache_shardings",
    "jit_prefill_step",
    "jit_decode_step",
    "Replica",
    "ServeFuture",
    "ServePool",
    "AutoscaleConfig",
    "request_size",
    "shape_cost_classifier",
]


# ----------------------------------------------------------------- structure
def abstract_caches(cfg: ModelConfig, bsz: int, cache_len: int, enc_len: int | None = None):
    """``meta``-device tensors matching what ``lm.prefill`` returns as caches.
    An enc-dec model's memory slot (``None`` in ``lm.init_caches``) holds
    the encoder-memory K/V ``[L, B, enc_len, Hkv, hd]`` (``enc_len``
    defaults to ``cache_len``, as in the reference)."""
    caches = lm.init_caches(cfg, bsz, cache_len, device="meta")
    if not cfg.enc_layers:
        return caches
    (((sa, _memory),),) = caches  # one group of xdec blocks
    shape = (cfg.n_layers, bsz, enc_len or cache_len, cfg.n_kv_heads, cfg.head_dim_)
    return [((sa, (sa[0].new_empty(shape), sa[0].new_empty(shape))),)]


def _kv_spec(cfg, ctx, dp, seq: int) -> tuple:
    """[L, B, S, Hkv, hd] -- heads over 'model' if divisible, else sequence."""
    tp = ctx.tp_axis
    tpn = ctx.size(tp)
    if cfg.n_kv_heads % tpn == 0:
        return (None, dp, None, tp, None)
    if seq % tpn == 0:
        return (None, dp, tp, None, None)
    return (None, dp, None, None, None)


def cache_pspecs(cfg: ModelConfig, ctx: ParallelContext, bsz: int, cache_len: int):
    """Spec tree matching the prefill/decode cache structure."""
    if ctx.mesh is None:
        raise ValueError("cache_pspecs needs a context with a mesh")
    tp = ctx.tp_axis
    tpn = ctx.size(tp)
    dp = ctx.dp_spec(bsz)

    def div(n):  # 'model' only when divisible
        return tp if n % tpn == 0 else None

    def kind_spec(kind: str):
        if kind in ("attn", "attn_dense", "attn_moe"):
            if cfg.mla is not None:
                s = div(cache_len)
                return ((None, dp, s, None), (None, dp, s, None))
            kv = _kv_spec(cfg, ctx, dp, cache_len)
            return (kv, kv)
        if kind == "local":
            kv = _kv_spec(cfg, ctx, dp, cfg.window or cache_len)
            return (kv, kv)
        if kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            h = d_in // s.head_dim
            conv_ch = d_in + 2 * s.n_groups * s.d_state
            return ((None, dp, div(h), None, None), (None, dp, None, div(conv_ch)))
        if kind == "rglru":
            w = cfg.rglru.lru_width
            return ((None, dp, div(w)), (None, dp, None, div(w)))
        if kind == "xdec":
            kv = _kv_spec(cfg, ctx, dp, cache_len)
            return ((kv, kv), (kv, kv))
        raise ValueError(kind)

    return [tuple(kind_spec(k) for k in lm._group_kinds(kind))
            for kind, _count in lm._decoder_groups(cfg)]


def cache_shardings(cfg, ctx, bsz, cache_len):
    return map_specs(lambda s: NamedSharding(ctx.mesh, s),
                     cache_pspecs(cfg, ctx, bsz, cache_len))


def _param_shardings(cfg: ModelConfig, ctx: ParallelContext):
    params, axes = lm.init_shapes(cfg)
    return shardings_for(axes, ctx, params)


# ---------------------------------------------------------------- step makers
def jit_prefill_step(cfg: ModelConfig, ctx: ParallelContext | None = None,
                     batch_sds: dict | None = None):
    """``prefill_step(params, batch) -> (logits, caches)``.

    With a mesh, ``batch_sds`` (tensors or ``meta`` stand-ins of the batch)
    fixes the batch and cache layouts: parameters go in by the sharding
    rules, the batch over the DP axes, and the caches come out in
    ``cache_pspecs``' layout for the prompt's length."""
    mesh = getattr(ctx, "mesh", None)

    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, ctx if mesh is not None else None)

    if mesh is None:
        return prefill_step
    param_sh = _param_shardings(cfg, ctx)
    b_sh = batch_shardings(batch_sds, ctx)
    ref = batch_sds.get("tokens", batch_sds.get("embeds", batch_sds.get("enc_embeds")))
    bsz, seq = ref.shape[0], ref.shape[1]
    cache_sh = cache_shardings(cfg, ctx, bsz, seq)

    def sharded_prefill(params, batch):
        logits, caches = prefill_step(distribute_tree(params, param_sh),
                                      distribute_tree(batch, b_sh))
        return logits, distribute_tree(caches, cache_sh)

    return sharded_prefill


def jit_decode_step(
    cfg: ModelConfig,
    ctx: ParallelContext | None = None,
    bsz: int | None = None,
    cache_len: int | None = None,
    *,
    serve_layout: bool = True,
):
    """``decode(params, tokens, caches, pos) -> (logits, caches)``.

    The caches passed in are always updated in place and returned, the
    port's form of the reference's donated buffers.  With a mesh, ``bsz``
    and ``cache_len`` fix the cache layout (``cache_pspecs``) and
    ``serve_layout`` picks the inference parameter layout
    (``serve_context``): dense weights TP-only, experts full-EP.  Pass
    False to keep the training layout.
    """
    mesh = getattr(ctx, "mesh", None)
    if mesh is not None and serve_layout:
        ctx = serve_context(mesh, cfg.moe.num_experts if cfg.moe else 0)

    def decode(params, tokens, caches, pos):
        return lm.decode_step(params, tokens, caches, pos, cfg, ctx if mesh is not None else None)

    if mesh is None:
        return decode
    param_sh = _param_shardings(cfg, ctx)
    cache_sh = cache_shardings(cfg, ctx, bsz, cache_len)
    tok_sh = NamedSharding(mesh, (ctx.dp_spec(bsz), None))

    def sharded_decode(params, tokens, caches, pos):
        logits, caches = decode(distribute_tree(params, param_sh),
                                distribute_tree(tokens, tok_sh),
                                distribute_tree(caches, cache_sh), pos)
        return logits, distribute_tree(caches, cache_sh)

    return sharded_decode


# -------------------------------------------------------------- host serving
def request_size(request: dict) -> float:
    """Scalar work proxy read off a request's SHAPE (DESIGN.md
    §Work-weighted stealing).

    Checked in order: an explicit step/length scalar (``nt`` — seismic shot
    time steps, ``steps``, ``max_new_tokens``, ``new_tokens``), then the
    length of a sized payload (``tokens``, ``prompt``, ``inputs``,
    ``receivers``).  Unrecognisable requests size to 1.0, which lands them
    in the lowest cost class — never an error: sizing is an accounting hint,
    not validation.
    """
    for key in ("nt", "steps", "max_new_tokens", "new_tokens"):
        v = request.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    for key in ("tokens", "prompt", "inputs", "receivers"):
        v = request.get(key)
        if v is not None and hasattr(v, "__len__"):
            return float(len(v))
    return 1.0


def shape_cost_classifier(bounds: Sequence[float]) -> Callable[[dict], int]:
    """Cost-class inference from request shape: class = number of ``bounds``
    the request's :func:`request_size` exceeds (so ``bounds=(100,)`` gives
    two classes: ≤100 → 0, >100 → 1).  This is what ``ServePool`` installs
    when given ``cost_class_bounds`` — replicas then publish per-class EWMA
    service times through the scheduler's information ring and queues are
    priced in estimated work-seconds rather than request counts."""
    edges = sorted(float(b) for b in bounds)

    def classify(request: dict) -> int:
        s = request_size(request)
        return sum(1 for e in edges if s > e)

    return classify


@dataclass
class Replica:
    """One model replica (device slice / pod) with a relative speed."""

    name: str
    generate: Callable[[dict], dict]  # request -> response
    slow_factor: float = 1.0


@dataclass
class AutoscaleConfig:
    """Autoscaler for an elastic ``ServePool`` (DESIGN.md §Elasticity,
    §SLO serving).

    A background watcher samples the pool every ``interval`` seconds and
    acts in one of two modes:

    ``mode="threshold"`` (the PR-3 reactive scaler):

    * **scale OUT** when the request backlog exceeds
      ``high_pending_per_replica`` × live replicas (queueing theory's "the
      pool is past saturation" signal — pending() counts queued + in-flight,
      so the bound is in units of requests-per-server) and the pool is below
      ``max_replicas``: ``factory(worker_id)`` builds the new replica.
    * **scale IN** when ``pending() == 0`` for ``idle_ticks_to_retire``
      consecutive samples and the pool is above ``min_replicas``: the
      highest-numbered live replica is drained back out (LIFO, so the boot
      replicas — typically the fast reserved capacity — stay).

    ``mode="predictive"``: Holt's double-exponential forecast of the
    ARRIVAL rate instead of the instantaneous backlog.  Each tick observes
    the submit rate since the last tick, updates level/trend EWMAs
    (``rate_alpha``/``trend_beta``), and provisions capacity against the
    forecast ``level + trend × horizon`` at ``target_util`` utilisation,
    where per-replica capacity is the observed mean service rate (served
    tasks / busy seconds, pool-wide).  The pool scales out while live <
    wanted and recedes (one per tick, only when the backlog is already
    small) when live > wanted — reserves come up BEFORE the backlog a
    threshold scaler needs as evidence, which is what rescues the latency
    tail on a diurnal ramp.  Until a service-time observation exists the
    predictive mode stands pat (no capacity estimate to provision against).

    **Straggler interaction** (DESIGN.md §Straggler plane): when the pool
    runs with limp detection (``ServePool(limp=...)``), a flagged replica is
    degraded capacity the backlog bound must not count on.  With
    ``limp_scale_out`` the scale-out test divides the backlog by HEALTHY
    replicas only (live minus limping), so a limping replica reads as load
    and triggers a surge replica early.  Once the scheduler has stripped a
    limping replica's deque (the re-pricing path), ``drain_limping_ticks``
    consecutive samples of flagged-and-empty drain it out of the pool like
    ``retire_replica(drain=True)`` — recorded as a ``"limp"`` scale event —
    guarded by ``min_replicas``.  Both knobs are inert when limp detection
    is off (nothing ever flags).
    """

    factory: Callable[[int], Replica]  # worker id -> new Replica
    min_replicas: int = 1
    max_replicas: int = 8
    high_pending_per_replica: float = 4.0
    idle_ticks_to_retire: int = 3
    interval: float = 0.02
    limp_scale_out: bool = True
    drain_limping_ticks: int = 3
    mode: str = "threshold"  # "threshold" | "predictive"
    rate_alpha: float = 0.3  # predictive: level EWMA weight
    trend_beta: float = 0.2  # predictive: trend EWMA weight
    horizon: float = 5.0  # predictive: forecast look-ahead, in ticks
    target_util: float = 0.75  # predictive: provisioned utilisation target

    def __post_init__(self) -> None:
        if self.mode not in ("threshold", "predictive"):
            raise ValueError(f"unknown autoscale mode {self.mode!r}")


class ServeFuture:
    """Handle for one in-flight request submitted to a live ``ServePool``.

    The scheduler moves the request between replica deques (steals) until a
    replica executes it; ``result()`` blocks until then.  Timing telemetry:
    ``submit_t`` (entered the pool), ``start_t``/``end_t`` (execution on the
    serving replica), ``latency`` = end - submit (the open-arrival sojourn
    time the §Open-arrival design optimises for).

    SLO attributes (DESIGN.md §SLO serving): ``slo_class`` (SLO_BATCH /
    SLO_LATENCY) and an ABSOLUTE ``deadline`` (pool-clock seconds; +inf =
    none).  These are what the scheduler's SLO-ordered owner pops and
    ``RunStats.slo_stats`` read off the future (the duck-typed face of
    ``core.deque.Task``, with ``submit_t`` as the arrival stamp).
    """

    __slots__ = (
        "request", "response", "error", "worker",
        "submit_t", "start_t", "end_t", "slo_class", "deadline", "_done",
    )

    def __init__(self, request: dict) -> None:
        self.request = request
        self.response: dict | None = None
        self.error: BaseException | None = None
        self.worker: int | None = None  # replica that ultimately served it
        self.submit_t: float = float("nan")
        self.start_t: float = float("nan")
        self.end_t: float = float("nan")
        self.slo_class: int = SLO_BATCH
        self.deadline: float = math.inf
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError("request not served in time")
        if self.error is not None:
            raise self.error
        assert self.response is not None
        return self.response

    @property
    def latency(self) -> float:
        return self.end_t - self.submit_t


class ServePool:
    """Continuous-batching A2WS request pool over heterogeneous replicas.

    Requests are the paper's tasks; each replica is a worker whose deque the
    others steal from (open-arrival mode, DESIGN.md §Open-arrival).  The
    pool boots ONCE (``start``), serves streamed requests (``submit``) for
    its whole lifetime — fast replicas steal queued requests from slow ones
    mid-flight, across wave boundaries, with no teardown or re-partitioning
    in between — and drains at ``shutdown``.

    ``submit_all`` is the closed-batch convenience wrapper: it submits a
    wave into the live pool and waits for exactly that wave.

    ``policy`` selects the scheduling policy balancing the replica deques —
    "a2ws" (default), "ctws", "lw", "random", or a ``SchedPolicy`` instance
    — so the paper's baselines are benchmarkable head-to-head on latency
    percentiles under identical serving traffic.

    **Work-weighted serving** (DESIGN.md §Work-weighted stealing): variable-
    cost requests (long vs short generations, deep vs shallow shots) break
    count-based balancing — a queue of 3 heavy requests is "shorter" than a
    queue of 4 light ones.  ``cost_class_bounds=(100,)`` infers a cost class
    from each request's shape (:func:`request_size` thresholds — here ≤100 →
    class 0, >100 → class 1) and the scheduler prices replica queues in
    estimated work-seconds from per-class EWMA service times.  For payloads
    the shape heuristic cannot size, pass an explicit ``cost_class_fn``
    (request dict -> class index) with ``num_classes``.  Neither given →
    count-based scheduling, bit-for-bit the old behaviour.

    **Migration cost** (DESIGN.md §Topology plane): stealing a queued
    request between replicas is not free — the thief replica serves it
    cold (prefix cache, paged KV, warm weights all live on the victim).
    ``migration_cost`` is the per-request warm-state price in seconds,
    folded into every remote link of ``topology`` (or onto a zero-cost
    uniform topology when none is given) via ``Topology.add_per_task`` —
    so victim selection discounts distant/cold steals, net-negative
    migrations are refused, and the thief pays the cost before the loot
    lands, through exactly the same pricing hook as the network.  Both
    default to off (``topology=None, migration_cost=0.0``) = bit-for-bit
    the unpriced pool.
    """

    def __init__(
        self,
        replicas: list[Replica],
        *,
        radius: int | None = None,
        seed: int = 0,
        policy: str | SchedPolicy = "a2ws",
        autoscale: AutoscaleConfig | None = None,
        cost_class_bounds: Sequence[float] | None = None,
        cost_class_fn: Callable[[dict], int] | None = None,
        num_classes: int | None = None,
        slowdown: SlowdownSchedule | None = None,
        limp: LimpConfig | None = None,
        topology: Topology | None = None,
        migration_cost: float = 0.0,
        netfaults: NetFaultSchedule | None = None,
        slo_order: bool = False,
        slo_aging: float = math.inf,
    ):
        self.replicas = replicas
        self.radius = radius
        self.seed = seed
        self.policy = policy
        self.autoscale = autoscale
        # SLO plane (DESIGN.md §SLO serving): slo_order=True makes every
        # replica pop its own deque SLO-first (latency jumps batch, EDF
        # within class, batch older than slo_aging promoted); thief-end
        # steals still strip the oldest tail, i.e. batch work.  Off by
        # default — bit-for-bit the PR-9 pop path.
        if not slo_aging > 0.0:  # also rejects NaN
            raise ValueError(f"slo_aging {slo_aging} must be > 0 (or inf)")
        self.slo_order = slo_order
        self.slo_aging = slo_aging
        if migration_cost < 0.0 or migration_cost != migration_cost:
            raise ValueError("migration_cost must be >= 0")
        # Per-request warm-state weight rides the same pricing hook as the
        # network: fold it into every remote per-task cost of the topology
        # (a zero-cost uniform base when no network model was given).
        if migration_cost > 0.0:
            base = topology if topology is not None else Topology.uniform()
            topology = base.add_per_task(migration_cost, name=f"{base.name}+migration")
        self.topology = topology
        self.migration_cost = migration_cost
        # Fault plane (DESIGN.md §Fault fabric): injected into the replica
        # runtime's steal fabric (leases, backoff, partition degradation),
        # and consulted by submit() for partition-aware front-end routing.
        self.netfaults = netfaults
        self._route_rr = 0  # round-robin cursor for partition routing
        # Straggler plane (DESIGN.md §Straggler plane): ``slowdown`` scripts
        # degraded-but-alive faults into the replica runtime; ``limp``
        # enables the owner-side detector that re-prices a limping replica's
        # queue, stops routing submits to it, and (with autoscale) drains it.
        self.slowdown = slowdown
        self.limp = limp
        #: (wall time, replica id, flagged) limp-detector transitions —
        #: live view while serving, snapshotted across shutdown().
        self.limp_log: list[tuple[float, int, bool]] = []
        if cost_class_bounds is not None and cost_class_fn is not None:
            raise ValueError(
                "cost_class_bounds and cost_class_fn are mutually exclusive"
            )
        if cost_class_bounds is not None:
            self.cost_class_fn: Callable[[dict], int] | None = (
                shape_cost_classifier(cost_class_bounds)
            )
            self.num_classes = len(cost_class_bounds) + 1
        elif cost_class_fn is not None:
            if num_classes is None or num_classes < 2:
                raise ValueError(
                    "an explicit cost_class_fn needs num_classes >= 2"
                )
            self.cost_class_fn = cost_class_fn
            self.num_classes = num_classes
        else:
            self.cost_class_fn = None
            self.num_classes = 1
        #: (wall time, "out" | "in" | "limp", worker id, pending at decision)
        self.scale_events: list[tuple[float, str, int, int]] = []
        self.peak_live = len(replicas)
        self._scale_lock = threading.Lock()
        self._scale_stop = threading.Event()
        self._scaler: threading.Thread | None = None
        self._runtime: WorkerPool | None = None

    # ------------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        return self._runtime is not None

    def start(self) -> None:
        """Boot the replica workers; idempotent."""
        if self._runtime is not None:
            return

        def task_fn(wid: int, fut: ServeFuture) -> None:
            # A generate() failure propagates into the runtime's
            # fault-tolerance path: the replica is tombstoned, the future is
            # re-queued, and a SURVIVING replica re-serves it (transparent
            # retry).  The future is only resolved on success — or at
            # shutdown, if no survivor ever picked it up.
            rep = self.replicas[wid]
            fut.worker = wid
            fut.start_t = time.perf_counter()
            out = rep.generate(fut.request)
            if rep.slow_factor > 1.0:
                time.sleep(
                    (time.perf_counter() - fut.start_t)
                    * (rep.slow_factor - 1.0)
                )
            fut.response = out
            fut.end_t = time.perf_counter()
            fut._done.set()

        # The pool's tasks are ServeFutures: classify through the wrapped
        # request so user classifiers keep their dict-in/int-out signature.
        classify = self.cost_class_fn
        rt = WorkerPool(
            [],
            len(self.replicas),
            task_fn,
            policy=self.policy,
            radius=self.radius,
            seed=self.seed,
            open_arrival=True,
            cost_class_fn=(
                None if classify is None
                else lambda fut: classify(fut.request)
            ),
            num_classes=self.num_classes,
            slowdown=self.slowdown,
            limp=self.limp,
            topology=self.topology,
            netfaults=self.netfaults,
            slo=self.slo_order,
            slo_aging=self.slo_aging,
        )
        # Share the runtime's transition log so limp telemetry stays
        # readable after shutdown() drops the runtime reference.
        self.limp_log = rt.limp_log
        # If the LAST replica dies, nothing will ever serve the queued
        # requests — fail their futures immediately instead of letting
        # result() (and submit_all) hang forever.
        rt.on_collapse = self._fail_unserved
        rt.start()
        self._runtime = rt
        if self.autoscale is not None:
            self._scale_stop.clear()
            self._scaler = threading.Thread(
                target=self._autoscale_loop, daemon=True
            )
            self._scaler.start()

    def _fail_unserved(self, stranded: list) -> None:
        err = RuntimeError("all replicas died; request not served")
        for fut in stranded:
            if isinstance(fut, ServeFuture) and not fut.done():
                fut.error = err
                fut.end_t = time.perf_counter()
                fut._done.set()

    # ------------------------------------------------------------- elasticity
    def live_replicas(self) -> list[int]:
        """Ids of replicas currently serving (not dead, not draining)."""
        rt = self._runtime
        if rt is None:
            return []
        return [
            i for i in range(rt.num_workers)
            if not rt.dead[i] and not rt.workers[i].retiring
        ]

    def limping_replicas(self) -> list[int]:
        """Ids of LIVE replicas the limp detector currently flags (always
        empty when the pool runs without ``limp=``)."""
        rt = self._runtime
        if rt is None:
            return []
        return [i for i in self.live_replicas() if rt.limping(i)]

    def set_replica_slowdown(self, replica: int, factor: float) -> None:
        """Inject a live slowdown multiplier on one replica (fault
        injection / chaos testing): every task it executes stalls by
        ``factor`` on top of any scripted schedule.  ``factor=1.0``
        restores full speed."""
        if self._runtime is None:
            raise RuntimeError("pool not started")
        self._runtime.set_worker_slowdown(replica, factor)

    def add_replica(
        self, replica: Replica | Callable[[int], Replica]
    ) -> int:
        """Scale out: boot one more worker of the LIVE pool.  Queued
        requests flow to it through the ordinary steal path — no
        rebalancing pass, no pause.  Returns the replica id — a recycled
        slot of a previously retired/dead replica when one is free (the
        pool's ring stays bounded across surge cycles), else a fresh one.

        ``replica`` may be a ready ``Replica`` or a factory called with the
        ACTUAL assigned id — a recycled slot's id is only known at
        assignment time, so id-keyed replica config (device slice, name,
        endpoint) must be built there, not guessed from the list length."""
        if self._runtime is None:
            raise RuntimeError("pool not started")

        def place(wid: int) -> None:
            # Runs before the worker thread boots: task_fn indexes
            # self.replicas[wid], so the entry must exist first.
            rep = replica(wid) if callable(replica) else replica
            if wid == len(self.replicas):
                self.replicas.append(rep)
            else:
                self.replicas[wid] = rep

        with self._scale_lock:
            wid = self._runtime.add_worker(on_assign=place)
        self.peak_live = max(self.peak_live, len(self.live_replicas()))
        return wid

    def retire_replica(self, replica: int, drain: bool = True) -> None:
        """Scale in / maintenance: gracefully drain one replica out of the
        live pool (its queued requests move to survivors first).  The
        ``Replica`` object keeps its slot so ids stay stable."""
        if self._runtime is None:
            raise RuntimeError("pool not started")
        self._runtime.retire_worker(replica, drain=drain)

    def _autoscale_loop(self) -> None:
        cfg = self.autoscale
        assert cfg is not None
        idle_ticks = 0
        limp_ticks: dict[int, int] = {}  # replica -> consecutive flagged+empty
        # Predictive state: Holt's level+trend over the observed submit rate.
        prev_submitted: int | None = None
        level = 0.0
        trend = 0.0
        level_init = False
        while not self._scale_stop.wait(cfg.interval):
            rt = self._runtime
            if rt is None:
                return
            live = self.live_replicas()
            self.peak_live = max(self.peak_live, len(live))
            pending = rt.pending()
            limping = [i for i in live if rt.limping(i)]
            # A limping replica that the scheduler has already stripped
            # (empty deque) is pure drag: drain it like retire_replica
            # once it stays flagged-and-empty long enough.  One drain per
            # sample keeps the pool's reaction conservative.
            limp_ticks = {
                i: (limp_ticks.get(i, 0) + 1
                    if len(rt.workers[i].deque) == 0 else 0)
                for i in limping
            }
            ripe = [
                i for i, t in limp_ticks.items()
                if t >= cfg.drain_limping_ticks
            ]
            if ripe and len(live) > cfg.min_replicas:
                victim = min(ripe)
                self.retire_replica(victim, drain=True)
                self.scale_events.append(
                    (time.perf_counter(), "limp", victim, pending)
                )
                del limp_ticks[victim]
                limping.remove(victim)
                live.remove(victim)  # retiring now — not capacity
            # Limping replicas are degraded capacity: with limp_scale_out
            # the saturation bound counts healthy replicas only, so a
            # straggler reads as backlog and pulls in a surge replica.
            healthy = (
                len(live) - len(limping) if cfg.limp_scale_out else len(live)
            )
            if cfg.mode == "predictive":
                submitted = rt.submitted.load()
                if prev_submitted is not None:
                    inst = (submitted - prev_submitted) / cfg.interval
                    if not level_init:
                        level_init = True
                        level = inst  # first observation seeds the level
                    else:
                        lvl_prev = level
                        level = cfg.rate_alpha * inst + (
                            1.0 - cfg.rate_alpha
                        ) * lvl_prev
                        trend = cfg.trend_beta * (level - lvl_prev) + (
                            1.0 - cfg.trend_beta
                        ) * trend
                prev_submitted = submitted
                # Per-replica capacity from OBSERVED service times (served
                # tasks / busy seconds, pool-wide mean); no observation yet
                # -> stand pat, there is nothing to provision against.
                served = sum(w.executed for w in rt.workers)
                busy_s = sum(w.runtime_sum for w in rt.workers)
                if served <= 0 or busy_s <= 0.0:
                    continue
                rate_per_replica = served / busy_s
                lam = max(level + trend * cfg.horizon, 0.0)
                want = math.ceil(
                    lam / (cfg.target_util * rate_per_replica)
                )
                want = min(max(want, cfg.min_replicas), cfg.max_replicas)
                if healthy < want and len(live) < cfg.max_replicas:
                    wid = self.add_replica(cfg.factory)
                    self.scale_events.append(
                        (time.perf_counter(), "out", wid, pending)
                    )
                elif (
                    len(live) > want
                    and len(live) > cfg.min_replicas
                    and pending <= len(live)
                ):
                    # Recede one per tick, only once the backlog is small —
                    # draining a replica re-sprays its queue.
                    victim = max(live)  # LIFO: boot replicas stay
                    self.retire_replica(victim, drain=True)
                    self.scale_events.append(
                        (time.perf_counter(), "in", victim, pending)
                    )
            elif (
                pending > cfg.high_pending_per_replica * max(healthy, 1)
                and len(live) < cfg.max_replicas
            ):
                # The factory receives the ACTUAL slot id (recycled slots
                # make it differ from the replica-list length).
                wid = self.add_replica(cfg.factory)
                self.scale_events.append(
                    (time.perf_counter(), "out", wid, pending)
                )
                idle_ticks = 0
            elif pending == 0 and len(live) > cfg.min_replicas:
                idle_ticks += 1
                if idle_ticks >= cfg.idle_ticks_to_retire:
                    victim = max(live)  # LIFO: boot replicas stay
                    self.retire_replica(victim, drain=True)
                    self.scale_events.append(
                        (time.perf_counter(), "in", victim, 0)
                    )
                    idle_ticks = 0
            else:
                idle_ticks = 0

    def shutdown(self) -> RunStats:
        """Drain (no more submits), wait for quiescence, return final stats."""
        if self._runtime is None:
            raise RuntimeError("pool not started")
        if self._scaler is not None:
            self._scale_stop.set()
            self._scaler.join()
            self._scaler = None
        rt = self._runtime
        rt.drain()
        stats = rt.join()
        # Every replica that could serve a re-queued request has now had
        # the chance.  Unresolved futures come in two flavours: the ones a
        # dying replica was executing (rt.errors) and the ones still queued
        # on deques no surviving worker ever popped — fail both so no
        # waiter outlives the pool.
        for _wid, fut, err in rt.errors:
            if isinstance(fut, ServeFuture) and not fut.done():
                fut.error = err
                fut.end_t = time.perf_counter()
                fut._done.set()
        self._fail_unserved(rt.drain_leftover_tasks())
        self._runtime = None
        return stats

    # -------------------------------------------------------------- requests
    def _partition_route(self) -> int | None:
        """Partition-aware front-end routing (DESIGN.md §Fault fabric).

        While a partition is active, the default round-robin would spray
        requests uniformly — those landing on the minority side cannot be
        stolen across the cut, so the majority's capacity sits idle while
        the minority drowns.  Instead, pick (round-robin) a live replica in
        the LARGEST reachable component; if every member of a component has
        died, retry with the next-largest one.  Returns ``None`` when no
        partition is active, every live replica sits in one component, or
        no component has a live member — the caller then falls back to the
        default router.
        """
        nf, rt = self.netfaults, self._runtime
        if nf is None or not nf.partitions or rt is None or rt._t0 is None:
            return None
        t = rt.clock() - rt._t0
        active = [p for p in nf.partitions if p.start <= t < p.end]
        if not active:
            return None
        groups: dict[tuple, list[int]] = {}
        for w in range(rt.num_workers):
            if rt.dead[w]:
                continue
            label = tuple(w in p._side_set for p in active)
            groups.setdefault(label, []).append(w)
        if len(groups) <= 1:
            return None
        # Only live replicas enter groups, so a fully-dead component is
        # skipped by construction — iterating largest-first IS the submit
        # retry across components.
        for members in sorted(groups.values(), key=lambda g: (-len(g), g[0])):
            if members:
                self._route_rr += 1
                return members[self._route_rr % len(members)]
        return None

    def submit(
        self,
        request: dict,
        *,
        replica: int | None = None,
        slo_class: int | str | None = None,
        deadline: float | None = None,
    ) -> ServeFuture:
        """Inject one request into the live pool (thread-safe); returns a
        ``ServeFuture``.  ``replica`` pins the initial deque (tests/traces);
        default routing round-robins and lets stealing do the balancing —
        except while a partition is active (``netfaults``), where the
        request routes into the largest reachable component instead
        (:meth:`_partition_route`).

        ``slo_class`` tags the request ``"latency"``/``"batch"`` (or the
        SLO_LATENCY/SLO_BATCH ints); ``deadline`` is a RELATIVE budget in
        seconds, resolved against the submit stamp into the absolute
        deadline the SLO-ordered pops and ``RunStats.slo_stats`` act on.
        Both default to the batch/no-deadline degenerate case."""
        if self._runtime is None:
            self.start()
        fut = ServeFuture(request)
        if slo_class is not None:
            if isinstance(slo_class, str):
                try:
                    slo_class = SLO_NAMES.index(slo_class)
                except ValueError:
                    raise ValueError(
                        f"slo_class {slo_class!r} not in {SLO_NAMES}"
                    ) from None
            if slo_class not in (SLO_BATCH, SLO_LATENCY):
                raise ValueError(f"slo_class {slo_class} must be 0 or 1")
            fut.slo_class = int(slo_class)
        fut.submit_t = time.perf_counter()
        if deadline is not None:
            if not deadline > 0.0:  # also rejects NaN
                raise ValueError(f"deadline budget {deadline} must be > 0")
            fut.deadline = fut.submit_t + deadline
        assert self._runtime is not None
        if replica is None:
            replica = self._partition_route()
        try:
            self._runtime.submit(fut, worker=replica)
        except PoolCollapsed:
            # Every replica is dead: fail THIS request immediately (the
            # runtime either never accepted it, or swept it into the
            # collapse hook — which already failed it, making this a no-op).
            self._fail_unserved([fut])
            return fut
        if self._runtime.alive.load() == 0:
            # Pool collapsed (all replicas dead).  Redundant safety net: the
            # runtime's post-push sweep already routed every stranded future
            # through the collapse hook (ServePool always installs it before
            # start), making this a no-op via the fut.done() guard — kept so
            # a waiter can never hang even if the collapse protocol shifts.
            # Never drain here: the runtime reconciles its quiescence
            # counters when IT sweeps.
            self._fail_unserved([fut])
        return fut

    def submit_wave(
        self,
        requests: Sequence[dict],
        *,
        replica: int | None = None,
        slo_class: int | str | None = None,
        deadline: float | None = None,
    ) -> list[ServeFuture]:
        return [
            self.submit(
                r, replica=replica, slo_class=slo_class, deadline=deadline
            )
            for r in requests
        ]

    def stats(self) -> RunStats:
        """Live scheduler stats snapshot (callable while serving)."""
        if self._runtime is None:
            raise RuntimeError("pool not started")
        return self._runtime.stats_snapshot()

    def pending(self) -> int:
        return self._runtime.pending() if self._runtime is not None else 0

    # ------------------------------------------------------ closed-batch API
    def submit_all(self, requests: list[dict], seed: int = 0):
        """Serve one wave to completion on the LIVE pool and return
        ``(responses, stats)`` — kept signature-compatible with the old
        closed-batch ServePool, but no longer tears the pool down: calling
        it repeatedly reuses the same workers and deques, and requests of a
        later wave can be stolen the moment they are submitted.  ``stats``
        is a pool-lifetime snapshot (per-wave deltas: diff two snapshots).
        """
        del seed  # scheduler seeding is fixed at pool construction now
        futs = self.submit_wave(requests)
        responses = [f.result() for f in futs]
        return responses, self.stats()
