"""The program's spans in the trace (``portbench/spantrace.py``) and the
readers of the pool's idle counters, on hand-made events and on a small
traced run on the CPU."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import counts, devtrace, run, spantrace
from portbench.devtrace import Span, Trace
from portbench.spantrace import Op
from portbench.tests import small
from repro_torch.core.a2ws import RunStats

NEW_COUNTERS = ("sched.idle_with_work_s.shots", "train.idle_with_work_ms")
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
EXISTING = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW_COUNTERS]


def _stats(idle_with_work_s=0.0, makespan=2.0):
    return RunStats(makespan=makespan, records=[], steals=[(0.1, 0, 2, 1)], failed_steals=0,
                    info_cells_sent=0, corrections=0, idle_with_work_s=idle_with_work_s)


# --------------------------------------------------------- counter readers
def test_idle_with_work_readers_mean_the_pools():
    ctx = SimpleNamespace(counters={"surveys": [{"stats": _stats(1.0)}, {"stats": _stats(3.0)}],
                                    "pool_stats": [_stats(0.25), _stats(0.75)]})
    assert run.reader("sched.idle_with_work_s.shots")(ctx) == pytest.approx(2.0)
    assert run.reader("train.idle_with_work_ms")(ctx) == pytest.approx(500.0)


def test_idle_with_work_readers_give_none_without_the_counter():
    # a pool that does not count idle time, or a window without pools
    old = SimpleNamespace(makespan=1.0, steals=[], records=[])
    for counters in ({"surveys": [{"stats": old}], "pool_stats": [old]},
                     {"surveys": [], "pool_stats": []}):
        ctx = SimpleNamespace(counters=counters)
        for name in NEW_COUNTERS:
            assert run.reader(name)(ctx) is None


# ------------------------------------------------------------ span readers
def _train_trace():
    """Two steps on thread 1; workers 2 and 3 compute and pace; the combine
    and the update launch on thread 1's stream 7."""
    step1, step2 = Span("pb.train.step", 0.0, 4.0, 1), Span("pb.train.step", 4.0, 8.0, 1)
    comb1, upd1 = Span("hetdp.combine", 2.5, 2.8, 1), Span("hetdp.update", 2.8, 3.5, 1)
    comb2, upd2 = Span("hetdp.combine", 6.5, 6.8, 1), Span("hetdp.update", 6.8, 7.5, 1)
    grad = Span("hetdp.grad", 0.0, 1.0, 2)
    spans = [step1, step2, comb1, upd1, comb2, upd2, grad,
             Span("hetdp.pace", 1.0, 2.0, 2), Span("hetdp.pace", 1.5, 2.2, 3),
             Span("hetdp.pace", 4.0, 6.0, 2)]
    ops = [Op("mm", 0.1, 1.0, 13, grad), Op("add", 2.6, 2.9, 7, comb1),
           Op("adamw", 2.9, 3.4, 7, upd1), Op("add", 6.6, 6.8, 7, comb2),
           Op("adamw", 6.8, 7.0, 7, upd2), Op("adamw", 7.1, 7.4, 7, upd2)]
    return Trace(window=(0.0, 8.0), ops=ops, spans=spans)


def test_train_span_readers():
    tr = _train_trace()
    assert spantrace.train_combine_ms(tr) == pytest.approx((0.3 + 0.2) / 2 * 1e3)
    assert spantrace.train_adamw_ms(tr) == pytest.approx((0.5 + 0.5) / 2 * 1e3)
    # idle: 0-0.1, 1.0-2.6, 3.4-6.6, 7.0-7.1, 7.4-8.0; paced 1.0-2.2 and 4.0-6.0
    unpaced = 0.1 + 0.4 + 0.6 + 0.6 + 0.1 + 0.6
    assert spantrace.train_idle_unpaced_pct(tr) == pytest.approx(unpaced / 8.0 * 100)


def test_shot_setup_reader():
    set1, set2 = Span("shot.setup", 0.0, 0.2, 2), Span("shot.setup", 1.0, 1.1, 3)
    steps = Span("shot.steps", 0.2, 0.9, 2)
    ops = [Op("mul", 0.05, 0.15, 5, set1), Op("fill", 0.1, 0.25, 5, set1),
           Op("fill", 1.05, 1.15, 6, set2), Op("fd3d_kernel", 0.3, 0.8, 5, steps)]
    tr = Trace(window=(0.0, 2.0), ops=ops, spans=[set1, set2, steps])
    assert spantrace.shot_setup_ms(tr) == pytest.approx((0.2 + 0.1) / 2 * 1e3)


@pytest.mark.parametrize("name", sorted(spantrace.SPAN_METRICS))
def test_span_readers_give_none_without_program_spans(name):
    # the harness's trace of a program without spans: pb.* spans, plain ops
    tr = Trace(window=(0.0, 4.0),
               ops=[devtrace.Op("mm", 0.5, 1.0, 7), devtrace.Op("fd3d_kernel", 1.0, 2.0, 13)],
               spans=[Span("pb.train.step", 0.0, 2.0, 1), Span("pb.shot", 0.0, 2.0, 2)])
    assert spantrace.SPAN_METRICS[name](tr) is None


def test_difference():
    assert spantrace.difference([(0, 4), (5, 8)], [(1, 2), (3, 6), (7, 9)]) == \
        [(0, 1), (2, 3), (6, 7)]
    assert spantrace.difference([(0, 1)], []) == [(0, 1)]


# ------------------------------------------------- launches by correlation
class _Event:
    def __init__(self, name, start, end, thread=0, dev=DeviceType.CPU, corr=0, link=0,
                 annotation=False, stream=0):
        self._v = (name, start, end, thread, dev, corr, link, annotation, stream)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]

    def device_resource_id(self):
        return self._v[8]


def _profiler(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_ops_take_the_innermost_span_of_their_launching_thread():
    cuda = DeviceType.CUDA
    events = [
        _Event("pb.window", 1000, 9000, 1, annotation=True, corr=1),
        _Event("a2ws.task", 2000, 8000, 2, annotation=True, corr=2),
        _Event("shot.setup", 2100, 3000, 2, annotation=True, corr=3),
        _Event("aten::mul", 2200, 2300, 2, corr=10),
        _Event("aten::fill_", 3500, 3600, 2, corr=11),  # after shot.setup, in a2ws.task
        _Event("aten::mm", 2500, 2600, 3, corr=12),  # a thread without spans
        _Event("user::ignored", 2000, 9000, 4, annotation=True, corr=13),
        _Event("mul_kernel", 2400, 2600, 0, cuda, corr=90, link=10, stream=7),
        _Event("fill_kernel", 3700, 3800, 0, cuda, corr=91, link=11, stream=7),
        _Event("gemm", 2700, 4000, 0, cuda, corr=92, link=12, stream=9),
        _Event("shot.setup", 2400, 2600, 0, cuda, corr=93, annotation=True),  # device annotation
        _Event("orphan", 5000, 5100, 0, cuda, corr=94, link=77, stream=9),
        _Event("stencil", 6000, 6100, 0, cuda, corr=95, link=0, stream=7),  # no operator around
        _Event("aten::unnumbered", 5900, 5950, 2, corr=0),
        # the profiler's other host events number theirs apart: an id equal
        # to an operator's names another event
        _Event("cudaLaunchKernel", 2250, 2260, 2, corr=12, link=10),
        _Event("cuLaunchKernel", 8000, 8100, 2, corr=10),
        _Event("Lazy Function Loading", 2000, 2010, 1, corr=11),
    ]
    tr = spantrace.collect(_profiler(events))
    assert tr.window == (0.0, pytest.approx(8e-6))
    assert sorted(s.name for s in tr.spans) == ["a2ws.task", "shot.setup"]
    by_name = {o.name: o for o in tr.ops}
    assert set(by_name) == {"mul_kernel", "fill_kernel", "gemm", "orphan", "stencil"}
    assert by_name["mul_kernel"].span.name == "shot.setup"
    assert by_name["fill_kernel"].span.name == "a2ws.task"
    assert by_name["gemm"].span is None and by_name["orphan"].span is None
    assert by_name["stencil"].span is None
    assert by_name["mul_kernel"].start == pytest.approx(1.4e-6)
    assert spantrace.clock_check(tr) == {"ops": 1, "early": 0, "worst_lead_s": 0.0}


# ------------------------------------------------------- the idle split
def _devtrace_trace():
    """``test_portbench_trace``'s trace."""
    ops = [devtrace.Op("k1", 0.0, 1.0, 7), devtrace.Op("k1", 0.5, 1.5, 13),
           devtrace.Op("mul", 3.0, 3.5, 13)]
    spans = [Span("pb.survey", 0.0, 4.0, 1), Span("pb.shot", 0.0, 1.5, 2),
             Span("pb.shot", 2.0, 3.6, 2)]
    return Trace(window=(0.0, 4.0), ops=ops, spans=spans)


def test_gaps_are_cut_at_every_span_bound():
    tr = _devtrace_trace()
    pieces = spantrace.idle_pieces(tr)
    # 1.5-2.0 and 3.6-4.0 between shots; 2.0-3.0 and 3.5-3.6 inside the second
    assert pieces == {"pb.survey": pytest.approx(0.9), "pb.shot+pb.survey": pytest.approx(1.1)}
    b = spantrace.breakdown(tr)
    assert b["device_ops"] == devtrace.breakdown(tr)["device_ops"]
    assert dict(b["idle_gaps"]) == pieces


def test_wait_after_a_shot_is_booked_to_the_stall():
    # a shot's last copy ends the card's work at 1.0; the worker's fetch
    # closes at 1.001, then the slowdown stalls it for 3 s beside an idle thief
    spans = [Span("pb.survey", 0.0, 5.0, 1),
             Span("a2ws.task", 0.0, 1.001, 2), Span("pb.shot", 0.0, 1.001, 2),
             Span("shot.fetch", 0.999, 1.001, 2), Span("a2ws.slow", 1.001, 4.0, 2),
             Span("a2ws.idle", 0.5, 4.5, 3)]
    tr = Trace(window=(0.0, 5.0), ops=[Op("copy", 0.0, 1.0, 7)], spans=spans)
    pieces = spantrace.idle_pieces(tr)
    assert pieces["a2ws.idle+a2ws.slow+pb.survey"] == pytest.approx(2.999)
    assert pieces["a2ws.idle+pb.survey+shot.fetch"] == pytest.approx(0.001)
    assert max(pieces, key=pieces.get) == "a2ws.idle+a2ws.slow+pb.survey"
    assert spantrace.program_share(pieces) == pytest.approx(3.5 / 4.0)  # 4.5-5.0 in none
    # devtrace, on its pb.* spans, books the whole gap to the shot, where it began
    pb = Trace(window=tr.window, ops=tr.ops, spans=[s for s in spans if s.name.startswith("pb.")])
    assert dict(devtrace.breakdown(pb)["idle_gaps"]) == {"pb.shot+pb.survey": pytest.approx(4.0)}


# ------------------------------------ the existing readers, spans or not
def _mixed_trace(with_program_spans: bool) -> Trace:
    pb = [Span("pb.survey", 0.0, 10.0, 1), Span("pb.shot", 0.0, 4.0, 2),
          Span("pb.shot", 5.0, 9.0, 3), Span("pb.train.step", 10.0, 14.0, 1),
          Span("pb.train.step", 14.0, 18.0, 1)]
    prog = [Span("shot.setup", 0.0, 0.5, 2), Span("shot.steps", 0.5, 3.5, 2),
            Span("a2ws.idle", 4.0, 6.0, 2), Span("hetdp.update", 13.0, 14.0, 1),
            Span("hetdp.pace", 11.0, 12.0, 4)]
    raw = [("fill", 0.1, 0.4, 5), ("fd3d_kernel", 0.6, 3.0, 5), ("mul", 3.0, 3.4, 5),
           ("fd3d_kernel", 5.5, 8.5, 6), ("mm", 10.5, 12.5, 8), ("adamw", 13.1, 13.9, 7),
           ("mm", 14.5, 16.5, 9), ("adamw", 17.1, 17.9, 7)]
    if not with_program_spans:
        return Trace(window=(0.0, 18.0), ops=[devtrace.Op(*r) for r in raw], spans=pb)
    launch = {0: prog[0], 2: prog[1], 5: prog[3]}
    ops = [Op(*r, launch.get(i)) for i, r in enumerate(raw)]
    return Trace(window=(0.0, 18.0), ops=ops, spans=pb + prog)


def _counters():
    stats = [_stats(0.5, makespan=3.0), _stats(0.0, makespan=3.5)]
    return {"surveys": [{"stats": s} for s in stats], "cells": 120_000_000, "shot_steps": 800,
            "counts": counts, "pool_stats": stats, "microbatch_s": 0.23, "tasks": 9,
            "slowdowns": [1.0, 1.0, 4.0], "pace": 1.0, "step_flops": 2.0e14}


@pytest.mark.parametrize("metric", EXISTING)
def test_existing_readers_read_the_same_with_program_spans(metric):
    read = run.reader(metric)
    values = [read(SimpleNamespace(trace=_mixed_trace(on), counters=_counters(),
                                   window_peak_bytes=7.7e9)) for on in (False, True)]
    assert values[0] == values[1]


# ------------------------------------------- a traced run on the CPU
@pytest.mark.parametrize("cell", ["overthrust-uniform", "phi4-hetdp-train"])
def test_traced_run_collects_the_programs_spans(cell, monkeypatch):
    kept = []
    monkeypatch.setattr(devtrace, "start_profiler", spantrace.start_profiler)
    monkeypatch.setattr(devtrace, "collect", lambda prof: kept.append(spantrace.collect(prof)) or kept[-1])
    monkeypatch.setattr(devtrace, "breakdown", spantrace.breakdown)
    r = run.run_cell(cell, 2**31 + 99, 0.2, True, device="cpu", patch=small.CELLS[cell])
    assert r["correct"], r
    names = {s.name for s in kept[0].spans}
    prefix = "shot." if cell.startswith("overthrust") else "hetdp."
    assert "a2ws.task" in names and any(n.startswith(prefix) for n in names)
    assert all(n.startswith(("pb.",) + spantrace.PROGRAM_PREFIXES) for n in names)
    # the pool's counters reach the line; no device, so no device time
    new = [m for m in NEW_COUNTERS if cell in next(
        x for x in BENCH["per_layer"] if x["name"] == m)["workloads"]]
    assert new and all(m in r["metrics"] for m in new)
    from repro_torch import spans
    assert spans._recording is False  # collect turned recording off
