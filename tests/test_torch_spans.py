"""The port's spans (``repro_torch.spans``) and the pool's idle counters.

Under a profiler that records every thread, and with recording on, a
survey of shots through the A2WS pool and a two-step ``HetDPTrainer`` emit
each span of the table below, on the threads named, inside the span named
as its parent (the innermost span open around it on its own thread).  With
recording off no ``record_function`` is entered, and the results are the
same bit for bit.  The pool's ``RunStats`` count the idle waits spent
while another worker still held queued work.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import repro_torch.spans as spans
from repro_torch.core import A2WSRuntime, SlowdownEvent, SlowdownSchedule
from repro_torch.core.policy import SchedPolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec
from repro_torch.seismic import make_demo_model, make_shot_grid
from repro_torch.seismic.tasks import make_shot_task

torch.set_num_threads(1)

# span -> (the thread it runs on, its parent span or None)
TABLE = {
    "a2ws.task": ("worker", None),
    "a2ws.slow": ("worker", None),
    "a2ws.idle": ("worker", None),
    "a2ws.steal": ("worker", None),
    "shot.setup": ("worker", "a2ws.task"),
    "shot.steps": ("worker", "a2ws.task"),
    "shot.sync": ("worker", "a2ws.task"),
    "shot.fetch": ("worker", "a2ws.task"),
    "hetdp.streams": ("caller", None),
    "hetdp.pool": ("caller", None),
    "hetdp.combine": ("caller", None),
    "hetdp.update": ("caller", None),
    "hetdp.grad": ("worker", "a2ws.task"),
    "hetdp.accumulate": ("worker", "a2ws.task"),
    "hetdp.sync": ("worker", "a2ws.task"),
    "hetdp.pace": ("worker", "a2ws.task"),
}
SLOWED = SlowdownSchedule([SlowdownEvent(2, 0.0, 4.0)])


def _survey(n=12, nt=4, shots=9, policy="random", seed=0):
    """{source: seismogram} of a survey on three workers, the third slowed
    4x; the random policy plans a steal at every idle boundary."""
    model = make_demo_model(n=n, device="cpu")
    results = {}
    task_fn = make_shot_task(model, nt, 3, results)
    A2WSRuntime(make_shot_grid(model, shots, n_rec=4), 3, task_fn, seed=seed,
                policy=policy, slowdown=SLOWED).run()
    return results


def _toy_trainer(workers):
    """A least-squares toy on ``workers``, paced so tasks take a little
    time; its microbatches for a step."""

    def loss_fn(params, batch):
        err = batch["x"] @ params["w"] - batch["y"]
        return torch.mean(err**2), {}

    def batches(step, t=6):
        rng = np.random.default_rng(step)
        x = rng.normal(size=(t, 4, 3)).astype(np.float32)
        y = x @ np.asarray([1.0, -2.0, 0.5], np.float32)
        return [{"x": torch.from_numpy(a), "y": torch.from_numpy(b)} for a, b in zip(x, y)]

    trainer = HetDPTrainer(loss_fn, {"w": torch.zeros(3)}, workers, AdamWConfig(lr=1e-2),
                           base_task_time=2e-3)
    return trainer, batches


def _train(workers, steps=2):
    trainer, batches = _toy_trainer(workers)
    for s in range(steps):
        trainer.step(batches(s))
    return trainer


def _recorded_spans(prof):
    """[(name, start_ns, end_ns, thread)] of the program's spans."""
    prefixes = tuple(k.split(".")[0] + "." for k in TABLE)
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith(prefixes)]


def _parent(span, recorded):
    """The innermost recorded span around ``span`` on its thread."""
    name, a, b, th = span
    around = [s for s in recorded if s is not span and s[3] == th and s[1] <= a and b <= s[2]]
    return max(around, key=lambda s: s[1])[0] if around else None


def test_spans_nest_on_their_threads():
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    with spans.recording():
        prof.start()
        try:
            _survey()
            _train([WorkerSpec("a"), WorkerSpec("b"), WorkerSpec("c", slow_factor=3.0)])
        finally:
            prof.stop()
    recorded = _recorded_spans(prof)
    caller_threads = {s[3] for s in recorded if s[0] == "hetdp.pool"}
    assert len(caller_threads) == 1
    for name, (where, parent) in TABLE.items():
        mine = [s for s in recorded if s[0] == name]
        assert mine, f"no {name} span"
        for s in mine:
            assert (s[3] in caller_threads) == (where == "caller"), (name, s)
            assert _parent(s, recorded) == parent, (name, _parent(s, recorded))


class _Count:
    """A stand-in for ``record_function`` that counts its entries, by name."""

    def __init__(self):
        self.names = []
        self.lock = threading.Lock()

    @property
    def n(self):
        return len(self.names)

    def __call__(self, name):
        with self.lock:
            self.names.append(name)
        return torch.profiler.record_function(name)


def test_recording_off_enters_no_record_function(monkeypatch):
    count = _Count()
    monkeypatch.setattr(spans, "record_function", count)
    _survey(shots=6)
    _train([WorkerSpec("a"), WorkerSpec("b", slow_factor=2.0)], steps=1)
    assert count.n == 0
    with spans.recording():
        _train([WorkerSpec("a")], steps=1)
    assert count.n > 0


def test_results_equal_bit_for_bit_with_recording_on_and_off():
    off = _survey(shots=6)
    with spans.recording():
        on = _survey(shots=6)
    assert off.keys() == on.keys()
    for src in off:
        assert np.array_equal(off[src], on[src])
    # one worker: the order of the gradient's sums is fixed
    w_off = _train([WorkerSpec("a")]).params["w"]
    with spans.recording():
        w_on = _train([WorkerSpec("a")]).params["w"]
    assert torch.equal(w_off, w_on)


class _NeverSteal(SchedPolicy):
    name = "never"

    def on_boundary(self, view):
        return None


def _sleep_pool(tasks, workers, policy, slowdown=None):
    return A2WSRuntime(tasks, workers, lambda wid, t: time.sleep(t), seed=0,
                       policy=policy, slowdown=slowdown).run()


def test_idle_with_work_counts_waits_beside_queued_work():
    # the third worker, slowed 8x, holds two queued tasks while the others idle
    stats = _sleep_pool([0.01] * 9, 3, _NeverSteal(),
                        SlowdownSchedule([SlowdownEvent(2, 0.0, 8.0)]))
    assert stats.per_worker_tasks == [3, 3, 3]
    assert not stats.steals and stats.failed_steals == 0
    assert stats.idle_with_work_s > 0.05
    # two idle workers can wait no longer than the run
    assert stats.idle_with_work_s <= 2 * stats.makespan


def test_idle_without_queued_work_is_not_counted_with_work():
    # one task a worker, and the short one ends only once the long one has
    # left its deque: every idle wait finds every deque empty
    popped = threading.Event()

    def task_fn(wid, t):
        if t == "long":
            popped.set()
            time.sleep(0.06)
        else:
            assert popped.wait(10.0)
            time.sleep(0.005)

    stats = A2WSRuntime(["short", "long"], 2, task_fn, seed=0, policy=_NeverSteal()).run()
    assert stats.per_worker_tasks == [1, 1]
    # the short task's worker idled through the long task's last 20 ms or more
    end = {r.task: r.end for r in stats.records}
    assert end["long"] - end["short"] > 0.02
    assert stats.idle_with_work_s == 0.0


@pytest.mark.parametrize("policy", ["random", "a2ws"])
def test_a_steal_span_for_every_executed_plan(policy, monkeypatch):
    # every plan the pool executes lands its loot, fails, or expires
    count = _Count()
    monkeypatch.setattr(spans, "record_function", count)
    with spans.recording():
        stats = _sleep_pool([0.004] * 24, 3, policy,
                            SlowdownSchedule([SlowdownEvent(2, 0.0, 6.0)]))
    plans = len(stats.steals) + stats.failed_steals + stats.lease_expired
    assert plans > 0
    assert count.names.count("a2ws.steal") == plans
    assert 0.0 <= stats.idle_with_work_s <= 2 * stats.makespan
