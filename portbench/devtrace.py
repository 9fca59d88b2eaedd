"""The traced window: ``torch.profiler`` (CPU and CUDA, every thread) over
the measured window, reduced to what the per-layer readers need.

The harness marks its own spans with ``torch.profiler.record_function``
ranges named ``pb.*`` around the calls into each layer (a survey's pool
run, each shot task, each trainer step).  ``collect`` reads the profiler's
raw events once (no per-event Python objects beyond three small records),
and gives:

- ``ops``: every device operation (kernels, copies, fills), with its stream;
- ``spans``: the harness's ``pb.*`` ranges, with their threads;
- ``window``: the ``pb.window`` range, all times in seconds from its start.

Interval arithmetic (union, clipping, gaps) lives here so that every reader
counts busy time the same way: concurrent streams share the card, so busy
time is the union of intervals, never the sum of durations.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "pb."
WINDOW_SPAN = "pb.window"
BREAKDOWN_ENTRIES = 10


@dataclass(frozen=True)
class Op:
    name: str
    start: float
    end: float
    stream: int


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float
    thread: int


@dataclass
class Trace:
    window: tuple[float, float]
    ops: list[Op] = field(default_factory=list)
    spans: list[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def busy_s(self, ops: list[Op] | None = None) -> float:
        """Seconds of the window in which at least one of ``ops`` (every op
        by default) ran on the device."""
        return total(clip(union((o.start, o.end) for o in (self.ops if ops is None else ops)),
                          *self.window))

    def closing_streams(self, spans: list[Span]) -> set[int]:
        """The streams of the last device operation to begin inside each of
        ``spans``: where a span's call ends with work on the caller's own
        stream (a trainer step ends with its update), the caller's stream."""
        starts = [o.start for o in self.ops]
        out = set()
        for s in spans:
            i = bisect.bisect_left(starts, s.end) - 1
            if i >= 0 and self.ops[i].start >= s.start:
                out.add(self.ops[i].stream)
        return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def total(intervals) -> float:
    return float(sum(b - a for a, b in intervals))


def intersect(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of ``[lo, hi]`` between sorted disjoint ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def start_profiler():
    """A started ``torch.profiler.profile`` over CPU and CUDA on every thread
    (worker threads and autograd's included)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True),
                   record_shapes=False, with_stack=False)
    prof.start()
    return prof


def collect(prof) -> Trace:
    """Reduce a stopped profiler's raw events to a :class:`Trace`: the device
    events that are not annotations, and the ``pb.*`` annotations."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    raw_ops, raw_spans = [], []
    for e in events:
        name, annotation = e.name(), e.is_user_annotation()
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                raw_ops.append((name, *span, e.device_resource_id()))
        elif annotation and name.startswith(SPAN_PREFIX):
            raw_spans.append((name, *span, e.start_thread_id()))
    windows = [s for s in raw_spans if s[0] == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW_SPAN} spans, expected 1")
    t0, t1 = windows[0][1], windows[0][2]
    sec = lambda ns: (ns - t0) * 1e-9  # noqa: E731
    ops = [Op(n, sec(a), sec(b), stream) for n, a, b, stream in raw_ops]
    spans = [Span(n, sec(a), sec(b), th) for n, a, b, th in raw_spans if n != WINDOW_SPAN]
    ops.sort(key=lambda o: o.start)
    return Trace(window=(0.0, sec(t1)), ops=ops, spans=spans)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time (summed by name) and the
    idle time between operations, summed by the harness spans that were open
    on the host when each gap began (every thread's innermost ``pb.*``
    span, joined with "+"; "none" where no span was open)."""
    by_op: dict[str, float] = defaultdict(float)
    for o in trace.ops:
        by_op[o.name[:120]] += o.end - o.start
    busy = clip(union((o.start, o.end) for o in trace.ops), *trace.window)
    idle: dict[str, float] = defaultdict(float)
    spans = trace.spans
    # a sweep over the spans' ends (0) and starts (1), ends first at a tie
    bounds = sorted([(s.start, 1, i) for i, s in enumerate(spans)]
                    + [(s.end, 0, i) for i, s in enumerate(spans)])
    open_by_thread: dict[int, list[int]] = defaultdict(list)
    k = 0
    for a, b in gaps(busy, *trace.window):
        while k < len(bounds) and bounds[k][0] <= a:
            _, opens, i = bounds[k]
            stack = open_by_thread[spans[i].thread]
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            k += 1
        label = "+".join(sorted({spans[st[-1]].name for st in open_by_thread.values() if st}))
        idle[label or "none"] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:BREAKDOWN_ENTRIES]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}
