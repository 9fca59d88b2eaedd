"""Device data-plane A2WS: the paper's scheduler as tensor operations.

The reference runs one program per worker under ``shard_map`` and moves
information with collectives.  Here every per-worker tensor carries a leading
worker dimension ``P`` and one process runs all workers on one device (the
card by default, the CPU when the caller asks for it):

* information ring (§2.1)  -> the two ``ppermute``s become one gather along
  dim 0: worker ``i`` reads its upper cells from worker ``i+1`` and its
  lower cells from worker ``i-1`` (a roll by -1 and by +1).  Each worker
  carries a (2R+1)-cell window of ``(n_j, t_j, q_j)``; R rounds refresh the
  radius.
* ``pmax``                 -> a max over dim 0.
* smart stealing (§2.2)    -> Eq. 5 steal rate, γ-rounding (Eqs. 6-8), the
  in-pair rule (Eq. 10) and probabilistic victim choice as tensor ops.
* asynchronous theft       -> one request/grant exchange: each
  ``all_to_all`` becomes a transpose of a ``[P, P]`` request or a
  ``[P, P, max_steal]`` payload tensor (row ``i`` is what worker ``i`` sends).
  The victim grants ``min(request, available)``.  With ``packed`` both cross
  the transpose as ``torch.uint16`` (the payload's empty slot is 0xFFFF, as in
  the reference) and are widened to int32 before any comparison or
  arithmetic; the baseline keeps int32 with -1 for an empty slot.

Randomness.  The reference carries a JAX key per worker in its state and
draws the victim with ``jax.random.categorical``, which is the argmax of
Gumbel noise plus the logits.  ``SchedState`` here carries no key: each round
takes its ``[P, 2R+1]`` Gumbel draws either from the caller's
``torch.Generator`` (uniforms drawn on the generator's device, turned into
Gumbel noise there and moved to the state's device, so a CPU generator gives
the card and the CPU the same draws) or, when ``gumbel`` is given, uses those
values as they are.

Float arithmetic follows the reference's CPU program where its rounding
decides integers: window sums in XLA's order (``_xla_sum``) and ``a * b + c``
rounded once, as XLA's fused multiply-add does (``_fma``).  The logarithm of
the victim weights runs in float64, so that the card and the CPU round alike.

The reference's module docstring names a ``plan_rebalance`` for the training
control plane; no such function exists in the reference, and this port adds
none.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from ..device import resolve_device

__all__ = [
    "SchedState",
    "init_state",
    "a2ws_round",
    "make_round_fn",
    "virtual_run",
    "steal_rate_window",
    "gamma_round",
]

_EPS = 1e-9
# CPU scalars for torch.maximum/minimum, which take no Python number: a binary
# op passes a 0-dim CPU tensor to the card's kernel as an argument, no copy.
_EPS_T = torch.tensor(_EPS, dtype=torch.float32)
_ZERO_T = torch.tensor(0.0, dtype=torch.float32)
_U16_EMPTY = 0xFFFF
_XLA_WINDOW = 32
_I32_MAX = 2**31 - 1


class SchedState(NamedTuple):
    """Per-worker scheduler state; leading dim = worker."""

    queue: torch.Tensor     # i32[P, cap]  task ids, valid in [head, tail)
    head: torch.Tensor      # i32[P]
    tail: torch.Tensor      # i32[P]
    executed: torch.Tensor  # i32[P]
    t_avg: torch.Tensor     # f32[P]      mean task runtime (virtual seconds)
    clock: torch.Tensor     # f32[P]      per-worker virtual time
    win_n: torch.Tensor     # f32[P, W]   window: total tasks n_j
    win_t: torch.Tensor     # f32[P, W]   window: mean runtime t_j
    win_q: torch.Tensor     # f32[P, W]   window: queued tasks q_j
    credit: torch.Tensor    # f32[P]      accumulated virtual time not yet spent


def init_state(
    num_workers: int,
    tasks_per_worker: Sequence[int] | torch.Tensor,
    speeds: Sequence[float] | torch.Tensor,
    radius: int,
    capacity: int,
    device: str | torch.device = "cuda",
) -> SchedState:
    """Static block partition (§2.2.1) across ``num_workers`` deques."""
    dev = resolve_device(device)
    p = num_workers
    w = 2 * radius + 1
    counts = torch.as_tensor(tasks_per_worker, dtype=torch.int32).to(dev)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # queue[i, s] = global task id offsets[i] + s  (valid while s < counts[i])
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
    queue = torch.where(slot < counts[:, None], offsets[:, None] + slot, -1)
    t0 = torch.as_tensor(speeds, dtype=torch.float32).to(dev).reciprocal()
    win_n = torch.zeros((p, w), dtype=torch.float32, device=dev)
    win_t = torch.full((p, w), math.nan, dtype=torch.float32, device=dev)
    win_q = torch.zeros((p, w), dtype=torch.float32, device=dev)
    win_n[:, radius] = counts.float()
    win_q[:, radius] = counts.float()
    zeros_i = torch.zeros(p, dtype=torch.int32, device=dev)
    zeros_f = torch.zeros(p, dtype=torch.float32, device=dev)
    return SchedState(
        queue=queue, head=zeros_i, tail=counts.clone(),
        executed=zeros_i.clone(), t_avg=t0, clock=zeros_f, win_n=win_n,
        win_t=win_t, win_q=win_q, credit=zeros_f.clone(),
    )


# ------------------------------------------------------------------ formulas
def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of the reference's CPU program.

    XLA's CPU backend sums a row of more than 32 left to right in windows of
    32 (zero padding split between both ends), then sums the window totals the
    same way.  Doing the same here makes the port's sums equal the reference's
    bit for bit, on the card as on the CPU.
    """
    w = x.shape[-1]
    if w > _XLA_WINDOW:
        n = -(-w // _XLA_WINDOW)
        pad = n * _XLA_WINDOW - w
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        return _xla_sum(_xla_sum(x.unflatten(-1, (n, _XLA_WINDOW))))
    total = x[..., 0]
    for k in range(1, w):
        total = total + x[..., k]
    return total


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA contracts it into an FMA.

    The f32 product is exact in float64, so only the sum rounds there first.
    """
    return (a.double() * b.double() + c.double()).float()


def _window_sums(win_n: torch.Tensor, win_t: torch.Tensor):
    """Eq. 5's N and T over the known cells of each window."""
    t = torch.where(torch.isnan(win_t), math.inf, torch.maximum(win_t, _EPS_T))
    known = torch.isfinite(t)
    inv = torch.where(known, t.reciprocal(), 0.0)
    n = torch.where(known, win_n, 0.0)
    return _xla_sum(torch.stack([n, inv])).unbind(0)


def steal_rate_window(win_n: torch.Tensor, win_t: torch.Tensor, radius: int) -> torch.Tensor:
    """Eq. 5 on a (2R+1)-cell window; index R = self.  Shape [..., W] -> [...]."""
    big_n, big_t = _window_sums(win_n, win_t)
    t_self = torch.maximum(win_t[..., radius], _EPS_T)
    return big_n / (t_self * torch.maximum(big_t, _EPS_T)) - win_n[..., radius]


def gamma_round(s, n_i, t_i, n_j, t_j) -> torch.Tensor:
    """Eqs. 6-8: round fractional steal rate to the γ-minimising integer."""
    s = torch.as_tensor(s, dtype=torch.float32)
    n_i, t_i, n_j, t_j = (torch.as_tensor(v, dtype=torch.float32, device=s.device)
                          for v in (n_i, t_i, n_j, t_j))
    lo = torch.floor(s)
    hi = torch.ceil(s)

    def u(amount, n, t):  # Eq. 6 (dimensionally-consistent product form)
        return torch.maximum(n + amount, _ZERO_T) * t

    g_lo = torch.maximum(u(-lo, n_j, t_j), u(lo, n_i, t_i))
    g_hi = torch.maximum(u(-hi, n_j, t_j), u(hi, n_i, t_i))
    amount = torch.where(g_lo < g_hi, lo, hi)
    # A NaN rate converts to 0, as in XLA (a bare cast gives INT_MIN on x86).
    return torch.where(torch.isnan(amount), 0.0, amount).to(torch.int32)


def _pair_rate(n_i, t_i, n_j, t_j):
    """Eq. 10."""
    return (n_i + n_j) * t_j / torch.maximum(t_i + t_j, _EPS_T) - n_i


def gumbel_draws(shape, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Gumbel(0, 1) noise drawn on ``generator``'s device, moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


# ------------------------------------------------------------------- round
def a2ws_round(
    state: SchedState,
    *,
    radius: int,
    max_steal: int,
    execute: bool = True,
    max_exec: int = 64,
    packed: bool = True,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> SchedState:
    """One scheduler round for all ``P`` workers at once.

    Sequence: (a) virtual-execute tasks for one virtual-time quantum;
    (b) refresh own window cell; (c) ring exchange; (d) steal-rate +
    victim selection; (e) request/grant exchange by transposes.  The victim's
    Gumbel noise is ``gumbel`` (``f32[P, 2R+1]``) when given, else drawn from
    ``generator``.
    """
    queue, head, tail, executed = state.queue, state.head, state.tail, state.executed
    t_avg, clock, credit = state.t_avg, state.clock, state.credit
    win_n, win_t, win_q = state.win_n, state.win_t, state.win_q
    p, cap = queue.shape
    w = 2 * radius + 1
    dev = queue.device
    rows = torch.arange(p, device=dev)

    # ------------------------------------- (a) execute one virtual quantum
    # One round = the slowest worker's task time (max over workers).  Each
    # worker spends its accumulated virtual-time credit on as many tasks as
    # its own speed affords, capped by ``max_exec``.  Idle workers do not
    # hoard credit.
    if execute:
        dt = t_avg.max()
        credit = credit + dt
        avail_q = (tail - head).clamp_min(0)
        k = torch.floor(credit / torch.maximum(t_avg, _EPS_T)).to(torch.int32)
        k = torch.minimum(k, avail_q).clamp_max(max_exec)
        head = head + k
        executed = executed + k
        clock = _fma(k.float(), t_avg, clock)
        credit = _fma(-k.float(), t_avg, credit)
        credit = torch.minimum(credit, dt)

    qlen = (tail - head).float()
    n_self = executed.float() + qlen
    # Preemptive estimate (§2.2.1): before the first finished task, t is the
    # elapsed virtual wall time (clock may be 0 at boot -> use t_avg prior).
    t_self = torch.where(executed > 0, t_avg, torch.maximum(clock, t_avg))

    # -------------------------------- (b) own cell, (c) ring info exchange
    # From RIGHT neighbour (i+1): its cells [R, 2R-1] -> my cells [R+1, 2R].
    # From LEFT  neighbour (i-1): its cells [1, R]    -> my cells [0, R-1].
    # Both shifts are one gather: cell c of worker i reads cell c - d of
    # worker i + d, d = sign(c - R), after every worker refreshed cell R.
    col = torch.arange(w, device=dev)
    d = torch.sign(col - radius)
    src_cell = torch.remainder(rows[:, None] + d, p) * w + (col - d)      # [P, W]
    own = torch.stack([n_self, t_self, qlen])[..., None]                 # [3, P, 1]
    win = torch.where(col == radius, own, torch.stack([win_n, win_t, win_q]))
    win = win.flatten(1).index_select(1, src_cell.flatten()).view(3, p, w)
    win_n, win_t, win_q = win.unbind(0)

    # ------------------------------------- (d) steal rate + victim selection
    # S_j per window cell, each from the SAME window (i's knowledge): Eq. 5
    # with cell c at the centre.  Rolling a window leaves its sums alone, so
    # one N and one T per worker serve every cell.
    big_n, big_t = _window_sums(win_n, win_t)
    s_cells = (big_n[:, None]
               / (torch.maximum(win_t, _EPS_T) * torch.maximum(big_t, _EPS_T)[:, None])
               - win_n)
    s_i = s_cells[:, radius]
    known = ~torch.isnan(win_t)
    not_self = col != radius
    has_q = win_q > 0.0
    surplus = (s_cells < 0.0) & has_q & known & not_self

    # Criterion 1 — closest rate: surplus volume scaled by match closeness.
    w1 = torch.maximum(-s_cells, _ZERO_T) / (
        1.0 + torch.abs(-s_cells - torch.maximum(s_i, _ZERO_T)[:, None])
    )
    # Criterion 2 — in-pair (Eq. 10) when no surplus candidate exists.
    pair = _pair_rate(n_self[:, None], t_self[:, None], win_n,
                      torch.where(known, win_t, math.inf))
    w2_mask = (pair > 0.0) & has_q & known & not_self
    use_pair = ~surplus.any(-1)
    cand = torch.where(use_pair[:, None], w2_mask, surplus)
    weights = torch.where(use_pair[:, None], torch.maximum(pair, _ZERO_T), w1)
    weights = torch.where(cand, weights, 0.0)

    if gumbel is None:
        if generator is None:
            raise ValueError("a2ws_round needs a generator or gumbel draws")
        gumbel = gumbel_draws((p, w), generator, dev)
    logits = torch.where(weights > 0.0, torch.log(weights.double()).float(), -math.inf)
    pick = torch.argmax(logits + gumbel, -1)
    any_cand = cand.any(-1)

    # Idle workers always steal (relay rule, see core.steal.plan_steal);
    # busy workers steal preemptively only when S_i > 0.
    idle = qlen <= 0.0
    use_pair_amt = use_pair | (s_i <= 0.0)
    at_pick = lambda x: x.gather(1, pick[:, None])[:, 0]  # noqa: E731
    want = torch.where(use_pair_amt, at_pick(pair),
                       torch.minimum(s_i, -at_pick(s_cells)))
    amount = gamma_round(torch.maximum(want, _ZERO_T), n_self, t_self,
                         at_pick(win_n), at_pick(win_t))
    amount = amount.clamp(0, max_steal)
    do_steal = ((s_i > 0.0) | idle) & any_cand & (amount > 0)
    victim = torch.remainder(rows + pick - radius, p)  # window cell -> worker id

    # ------------------------------------------ (e) request / grant exchange
    # req[i, j]: how many tasks i asks of j.  ``packed`` sends requests as
    # u16 (amounts <= max_steal << 65535), halving the exchanged bytes.
    req = torch.zeros((p, p), dtype=torch.int32, device=dev)
    req[rows, victim] = torch.where(do_steal, amount, 0)
    if packed:
        req_in = req.to(torch.uint16).t().contiguous().to(torch.int32)
    else:
        req_in = req.t().contiguous()  # req_in[i, j] = j's ask of i
    # Grant greedily, largest request first (stable on ties), bounded by my queue.
    order = torch.argsort(-req_in, dim=-1, stable=True)
    sorted_req = req_in.gather(1, order)
    avail = (tail - head).clamp_min(0)
    cum_before = torch.cumsum(sorted_req, -1, dtype=torch.int32) - sorted_req
    sorted_grant = torch.minimum((avail[:, None] - cum_before).clamp_min(0), sorted_req)
    grant = torch.zeros_like(req_in).scatter_(1, order, sorted_grant)
    grant_off = torch.zeros_like(req_in).scatter_(1, order, cum_before)
    total_grant = grant.sum(-1, dtype=torch.int32)

    # Payload [P, P, max_steal]: tasks popped from each sender's tail.
    sslot = torch.arange(max_steal, dtype=torch.int32, device=dev)
    src = tail[:, None, None] - 1 - (grant_off[:, :, None] + sslot)
    valid = sslot < grant[:, :, None]
    popped = queue.gather(1, src.clamp(0, cap - 1).reshape(p, -1).long()).reshape(src.shape)
    if packed and cap < _U16_EMPTY:
        # Task ids < capacity fit u16: the payload, the dominant exchange of
        # the round, travels as u16 with 0xFFFF marking an empty slot.
        payload = torch.where(valid, popped, _U16_EMPTY).to(torch.uint16)
        recv_ids = payload.transpose(0, 1).contiguous().to(torch.int32)
        got = recv_ids != _U16_EMPTY
    else:
        payload = torch.where(valid, popped, -1)
        recv_ids = payload.transpose(0, 1).contiguous()  # [i, j] = j's tasks for i
        got = recv_ids >= 0
    tail = tail - total_grant
    got = got.reshape(p, -1)
    recv_ids = recv_ids.reshape(p, -1)
    incoming = got.sum(-1, dtype=torch.int32)

    # Writes that fall outside a queue land in one spare slot past the
    # flattened queues, which is then dropped: the reference's scatter with
    # mode="drop".
    if packed:
        # Cumsum compaction (stable) instead of a full sort: received order
        # is irrelevant.
        dst = tail[:, None] + torch.cumsum(got, -1, dtype=torch.int32) - 1
        ok = got
        vals = recv_ids
    else:
        vals = torch.sort(torch.where(got, recv_ids, _I32_MAX), -1).values
        slots = torch.arange(vals.shape[1], dtype=torch.int32, device=dev)
        dst = tail[:, None] + slots
        ok = slots < incoming[:, None]
    ok = ok & (dst < cap)
    flat = torch.where(ok, rows[:, None] * cap + dst, p * cap)
    spill = torch.zeros(1, dtype=torch.int32, device=dev)
    queue = torch.cat([queue.flatten(), spill]).scatter_(0, flat.flatten(), vals.flatten())
    queue = queue[:-1].view(p, cap)
    tail2 = tail + incoming

    qlen2 = (tail2 - head).float()
    self_col = col == radius
    win_q = torch.where(self_col, qlen2[:, None], win_q)
    win_n = torch.where(self_col, (executed.float() + qlen2)[:, None], win_n)

    return SchedState(
        queue=queue, head=head, tail=tail2, executed=executed, t_avg=t_avg,
        clock=clock, win_n=win_n, win_t=win_t, win_q=win_q, credit=credit,
    )


def make_round_fn(num_workers: int, radius: int, max_steal: int,
                  execute: bool = True, packed: bool = True, *,
                  device: str | torch.device = "cuda") -> Callable[..., SchedState]:
    """The round over ``num_workers`` workers whose state lies on ``device``.

    The callable takes ``(state, generator=None, gumbel=None)``; there is no
    mesh: the worker axis is dim 0 of every tensor.
    """
    dev = resolve_device(device)

    def round_fn(state: SchedState, generator: torch.Generator | None = None,
                 gumbel: torch.Tensor | None = None) -> SchedState:
        if state.queue.shape[0] != num_workers or state.queue.device.type != dev.type:
            raise ValueError(
                f"state of {state.queue.shape[0]} workers on {state.queue.device}, "
                f"round made for {num_workers} on {dev}"
            )
        return a2ws_round(state, radius=radius, max_steal=max_steal,
                          execute=execute, packed=packed,
                          generator=generator, gumbel=gumbel)

    return round_fn


def virtual_run(
    num_workers: int,
    speeds,
    num_tasks: int,
    radius: int,
    max_steal: int = 8,
    max_rounds: int = 4096,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    packed: bool = True,
    generator: torch.Generator | None = None,
):
    """Run the scheduler to completion in virtual time.

    Returns (final_state, rounds, makespan).  A Python loop around the round
    reads the remaining task count once a round (one host sync); victims are
    drawn from ``generator``, or from a CPU generator seeded with ``seed``.
    """
    p = num_workers
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    base, rem = divmod(num_tasks, p)
    counts = [base + (1 if i < rem else 0) for i in range(p)]
    state = init_state(p, counts, speeds, radius, capacity=num_tasks, device=dev)
    round_fn = make_round_fn(p, radius, max_steal, packed=packed, device=dev)
    rounds = 0
    while rounds < max_rounds and int((state.tail - state.head).sum()) > 0:
        state = round_fn(state, generator)
        rounds += 1
    return state, rounds, float(state.clock.max())
