"""Seconds a survey in which workers waited idle while another worker's
deque still held a queued shot: ``RunStats.idle_with_work_s`` of each
survey's pool (summed over its workers), meaned over the surveys of the
window.  Work the scheduler left on a slow worker while thieves waited;
None where the pool does not count it."""


def read(ctx):
    idle = [getattr(s["stats"], "idle_with_work_s", None) for s in ctx.counters["surveys"]]
    if not idle or None in idle:
        return None
    return sum(idle) / len(idle)
