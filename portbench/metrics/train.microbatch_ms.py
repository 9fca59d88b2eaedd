"""Device time a microbatch: the union of the intervals of operations on
the workers' streams, over the window's microbatches, in ms.  The workers'
streams are every stream but the update's: the stream of the last device
operation in each traced step (a step ends with the AdamW update on the
caller's stream, after the pool and the combine)."""

from portbench.devtrace import total, union


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    steps = tr.spans_named("pb.train.step")
    if not steps:
        return None
    main = tr.closing_streams(steps)
    ops = [o for o in tr.ops if o.stream not in main]
    n = c["tasks"] * len(steps)
    return total(union((o.start, o.end) for o in ops)) / n * 1e3 if ops else None
