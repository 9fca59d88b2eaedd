"""The step epilogue's device time a shot step: the union of the intervals
of every device operation but K1 (``fd3d_kernel``) while shot tasks ran:
``run_shot``'s source add, its two mask multiplies and its receiver gather
(and the shot's set-up: c2dt2, the mask, the wavelet), over the shot steps
of the window, in ms."""

from portbench.devtrace import intersect, total, union


def read(ctx):
    tr, steps = ctx.trace, ctx.counters["shot_steps"]
    shots = union((s.start, s.end) for s in tr.spans_named("pb.shot"))
    rest = union((o.start, o.end) for o in tr.ops if "fd3d_kernel" not in o.name)
    if not shots or not steps or not rest:
        return None
    return total(intersect(rest, shots)) / steps * 1e3
