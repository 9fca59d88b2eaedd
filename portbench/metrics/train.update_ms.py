"""Device time of the combine and the AdamW update a step: the union of the
intervals of operations on the update's stream (the stream of the last
device operation in each traced step: the caller's, where the combine and
AdamW run after the pool), over the window's steps, in ms."""

from portbench.devtrace import total, union


def read(ctx):
    tr = ctx.trace
    steps = tr.spans_named("pb.train.step")
    if not steps:
        return None
    main = tr.closing_streams(steps)
    ops = [o for o in tr.ops if o.stream in main]
    return total(union((o.start, o.end) for o in ops)) / len(steps) * 1e3 if ops else None
