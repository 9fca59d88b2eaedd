"""The pool's makespan over the paced schedule's floor, meaned over the
window's steps: the floor is ``chip_smoke.py::paced_floor_ms``'s, from the
microbatch timed at set-up (the trainer's pacing), the step's tasks, the
workers' slowdowns and the pace (``counts.paced_floor_s``)."""


def read(ctx):
    c = ctx.counters
    stats = c["pool_stats"]
    if not stats:
        return None
    floor = c["counts"].paced_floor_s(c["microbatch_s"], c["tasks"], c["slowdowns"], c["pace"])
    return sum(s.makespan for s in stats) / len(stats) / floor
