"""Device time a shot step: the union of device-busy intervals while shot
tasks ran (the harness's ``pb.shot`` spans, every worker's), over the shot
steps of the window, in ms.  Concurrent shots share the card, so the union
counts each busy instant once."""

from portbench.devtrace import intersect, total, union


def read(ctx):
    tr, steps = ctx.trace, ctx.counters["shot_steps"]
    shots = union((s.start, s.end) for s in tr.spans_named("pb.shot"))
    if not shots or not steps:
        return None
    busy = union((o.start, o.end) for o in tr.ops)
    return total(intersect(busy, shots)) / steps * 1e3
