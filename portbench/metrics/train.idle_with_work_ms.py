"""Milliseconds a training step in which workers waited idle while another
worker's deque still held a queued microbatch: ``RunStats.idle_with_work_s``
of each window step's pool (``HetDPTrainer.history``, summed over its
workers), meaned over the steps; None where the pool does not count it."""


def read(ctx):
    idle = [getattr(s, "idle_with_work_s", None) for s in ctx.counters["pool_stats"]]
    if not idle or None in idle:
        return None
    return sum(idle) / len(idle) * 1e3
