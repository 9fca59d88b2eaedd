"""The program's own spans in the traced window, beside the harness's.

The port marks its work with ``repro_torch.spans`` (``a2ws.*`` in the pool,
``shot.*`` in a shot, ``hetdp.*`` in the trainer), recorded while
``repro_torch.spans.recording()`` is on.  This module holds what
``devtrace`` needs to read them:

- ``start_profiler``: devtrace's profiler, with the program's recording on
  until ``collect``;
- ``collect``: devtrace's trace with the program's spans beside the
  ``pb.*`` ones, and each device operation's launching span: the innermost
  span open, at the launch call, on the thread that launched it (the
  device event's ``linked_correlation_id`` is the ``correlation_id`` of the
  operator that launched it; only operators, named ``namespace::op``, and
  annotations take part in the match, since the profiler's other host
  events, CUDA runtime and driver calls and module loading, number theirs
  apart);
- ``idle_pieces`` and ``breakdown``: idle time cut at every span start and
  end inside a gap, each piece booked to the innermost spans open on every
  thread over it (devtrace books a whole gap to the spans open where it
  begins, so the wait that follows a shot's last copy is booked to the
  shot);
- ``SPAN_METRICS``, the per-layer metrics that read program spans, and
  ``clock_check``.

    python3 -m portbench.spantrace --workload NAME --seed N --seconds S

runs the harness's traced run of a cell (``run.run_cell``) with these in
devtrace's place, and prints its JSON line with a ``spans`` entry: the
span metrics, every idle piece, the share of idle time booked to program
spans and the clock check.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from collections import defaultdict
from dataclasses import dataclass

from portbench import devtrace
from portbench.devtrace import Span, Trace, gaps, intersect, total, union

PROGRAM_PREFIXES = ("a2ws.", "shot.", "hetdp.")
_recording = contextlib.ExitStack()
_devtrace_profiler, _devtrace_breakdown = devtrace.start_profiler, devtrace.breakdown


@dataclass(frozen=True)
class Op(devtrace.Op):
    span: Span | None = None  # the launching thread's innermost span at the launch


def start_profiler():
    """``devtrace.start_profiler``'s profiler, started with the program's
    span recording on; ``collect`` turns it off."""
    from repro_torch.spans import recording

    _recording.enter_context(recording())
    return _devtrace_profiler()


def _innermost(spans: list[Span]):
    """``at(thread, t)``: the innermost of ``spans`` open on ``thread`` at
    ``t`` (spans nest on their thread), or None."""
    timelines: dict[int, tuple[list[float], list[Span | None]]] = {}
    by_thread: dict[int, list[Span]] = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append(s)
    for th, mine in by_thread.items():
        bounds = sorted([(s.start, 1, k) for k, s in enumerate(mine)]
                        + [(s.end, 0, k) for k, s in enumerate(mine)])
        times, tops, stack = [], [], []
        for t, opens, k in bounds:
            if opens:
                stack.append(k)
            elif k in stack:
                stack.remove(k)
            times.append(t)
            tops.append(mine[stack[-1]] if stack else None)
        timelines[th] = (times, tops)

    def at(thread: int, t: float) -> Span | None:
        times, tops = timelines.get(thread, ((), ()))
        i = bisect.bisect_right(times, t) - 1
        return tops[i] if i >= 0 else None

    return at


def collect(prof) -> Trace:
    """A stopped profiler's trace: devtrace's, with the program's spans and
    each device operation's launching span."""
    from torch.autograd import DeviceType

    _recording.close()
    keep = (devtrace.SPAN_PREFIX,) + PROGRAM_PREFIXES
    raw_ops, raw_spans, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, annotation = e.name(), e.is_user_annotation()
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                raw_ops.append((name, *span, e.device_resource_id(), e.linked_correlation_id()))
        else:
            if annotation or "::" in name:  # an operator or an annotation
                launches[e.correlation_id()] = (e.start_thread_id(), span[0])
            if annotation and name.startswith(keep):
                raw_spans.append((name, *span, e.start_thread_id()))
    windows = [s for s in raw_spans if s[0] == devtrace.WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {devtrace.WINDOW_SPAN} spans, expected 1")
    t0, t1 = windows[0][1], windows[0][2]
    sec = lambda ns: (ns - t0) * 1e-9  # noqa: E731
    spans = [Span(n, sec(a), sec(b), th) for n, a, b, th in raw_spans if n != devtrace.WINDOW_SPAN]
    at = _innermost(spans)
    ops = []
    for n, a, b, stream, link in raw_ops:
        launch = launches.get(link) if link else None  # 0: launched outside any operator
        ops.append(Op(n, sec(a), sec(b), stream,
                      at(launch[0], sec(launch[1])) if launch is not None else None))
    ops.sort(key=lambda o: o.start)
    return Trace(window=(0.0, sec(t1)), ops=ops, spans=spans)


def idle_pieces(trace: Trace) -> dict[str, float]:
    """Every second in which no operation ran on the card, booked to the
    innermost spans open on every thread at that second (their names
    joined with "+", "none" where no span was open): each gap is cut at the
    start and the end of every span inside it."""
    spans = trace.spans
    # a sweep over the spans' ends (0) and starts (1), ends first at a tie
    bounds = sorted([(s.start, 1, i) for i, s in enumerate(spans)]
                    + [(s.end, 0, i) for i, s in enumerate(spans)])
    open_by_thread: dict[int, list[int]] = defaultdict(list)
    pieces: dict[str, float] = defaultdict(float)
    k = 0

    def apply(until: float) -> None:
        nonlocal k
        while k < len(bounds) and bounds[k][0] <= until:
            _, opens, i = bounds[k]
            stack = open_by_thread[spans[i].thread]
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            k += 1

    def label() -> str:
        return "+".join(sorted({spans[st[-1]].name for st in open_by_thread.values() if st})) \
            or "none"

    for a, b in gaps(_busy(trace), *trace.window):
        apply(a)
        p = a
        while k < len(bounds) and bounds[k][0] < b:
            t = bounds[k][0]
            if t > p:
                pieces[label()] += t - p
                p = t
            apply(t)
        pieces[label()] += b - p
    return dict(pieces)


def _busy(trace: Trace) -> list[tuple[float, float]]:
    return devtrace.clip(union((o.start, o.end) for o in trace.ops), *trace.window)


def breakdown(trace: Trace) -> dict:
    """devtrace's breakdown, its idle time booked by ``idle_pieces``."""
    out = _devtrace_breakdown(Trace(window=trace.window, ops=trace.ops, spans=[]))
    top = sorted(idle_pieces(trace).items(), key=lambda kv: -kv[1])
    out["idle_gaps"] = [[k, v] for k, v in top][:devtrace.BREAKDOWN_ENTRIES]
    return out


def program_share(pieces: dict[str, float]) -> float | None:
    """The share of idle time whose label names a program span."""
    idle = sum(pieces.values())
    named = sum(v for k, v in pieces.items()
                if any(p.startswith(PROGRAM_PREFIXES) for p in k.split("+")))
    return named / idle if idle > 0 else None


def difference(a, b) -> list[tuple[float, float]]:
    """``a`` less ``b``, both sorted disjoint interval lists."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, cur = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def _launched_under(trace: Trace, name: str) -> list[tuple[float, float]]:
    return union((o.start, o.end) for o in trace.ops
                 if getattr(o, "span", None) is not None and o.span.name == name)


def shot_setup_ms(trace: Trace) -> float | None:
    """Device time of a shot's set-up (c2dt2, the mask, the wavelet, the
    receiver index, the zeroed wavefields): the union of the operations
    launched under ``shot.setup``, over the shots, in ms."""
    n = len(trace.spans_named("shot.setup"))
    setup = _launched_under(trace, "shot.setup")
    return total(setup) / n * 1e3 if n and setup else None


def train_idle_unpaced_pct(trace: Trace) -> float | None:
    """The card's idle time inside training steps while no worker thread
    was in its pacing sleep (``hetdp.pace``), over the steps' wall, in %."""
    steps = union((s.start, s.end) for s in trace.spans_named("pb.train.step"))
    if not steps or not any(s.name.startswith("hetdp.") for s in trace.spans):
        return None
    idle = intersect(gaps(_busy(trace), *trace.window), steps)
    paced = union((s.start, s.end) for s in trace.spans_named("hetdp.pace"))
    return total(difference(idle, paced)) / total(steps) * 100.0


def _per_step_ms(trace: Trace, name: str) -> float | None:
    steps = trace.spans_named("pb.train.step")
    ops = _launched_under(trace, name)
    return total(ops) / len(steps) * 1e3 if steps and ops else None


def train_combine_ms(trace: Trace) -> float | None:
    """Device time of the combine (the accumulators' sum and the mean): the
    union of the operations launched under ``hetdp.combine``, a step, in ms."""
    return _per_step_ms(trace, "hetdp.combine")


def train_adamw_ms(trace: Trace) -> float | None:
    """Device time of the AdamW update: the union of the operations
    launched under ``hetdp.update``, a step, in ms."""
    return _per_step_ms(trace, "hetdp.update")


SPAN_METRICS = {
    "shot.setup_ms": shot_setup_ms,
    "train.idle_unpaced_pct": train_idle_unpaced_pct,
    "train.combine_ms": train_combine_ms,
    "train.adamw_ms": train_adamw_ms,
}


def clock_check(trace: Trace) -> dict:
    """Device operations launched under a ``shot.*`` or ``hetdp.*`` span,
    and how many of them start before that span starts (none where the
    host's and the card's clocks agree), with the largest such lead in s."""
    booked = [o for o in trace.ops if getattr(o, "span", None) is not None
              and o.span.name.startswith(("shot.", "hetdp."))]
    leads = [o.span.start - o.start for o in booked if o.start < o.span.start]
    return {"ops": len(booked), "early": len(leads), "worst_lead_s": max(leads, default=0.0)}


def report(trace: Trace) -> dict:
    """The ``spans`` entry of a run's line."""
    pieces = idle_pieces(trace)
    launched = [o for o in trace.ops if getattr(o, "span", None) is not None]
    return {
        "metrics": {k: f(trace) for k, f in SPAN_METRICS.items()},
        "idle_pieces": sorted(([k, v] for k, v in pieces.items()), key=lambda kv: -kv[1]),
        "program_share": program_share(pieces),
        "clock_check": clock_check(trace),
        "ops_with_launch_span": [len(launched), len(trace.ops)],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import run

    run.set_cache_dirs()
    kept = []
    devtrace.start_profiler = start_profiler
    devtrace.collect = lambda prof: kept.append(collect(prof)) or kept[-1]
    devtrace.breakdown = breakdown
    result = run.run_cell(args.workload, args.seed, args.seconds, True)
    result["spans"] = report(kept[0])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
