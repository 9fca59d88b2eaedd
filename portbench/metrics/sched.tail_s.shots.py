"""The scheduler's tail: each survey's end (its last task's end) minus the
time at which the first worker finished its last task, from
``RunStats.records``, meaned over the surveys of the window.  Seconds in
which some workers had nothing left to run or steal."""


def read(ctx):
    tails = []
    for s in ctx.counters["surveys"]:
        last: dict[int, float] = {}
        for r in s["stats"].records:
            last[r.worker] = max(last.get(r.worker, r.end), r.end)
        if last:
            tails.append(max(last.values()) - min(last.values()))
    return sum(tails) / len(tails) if tails else None
