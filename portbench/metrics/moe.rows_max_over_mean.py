"""The held experts' padding, in x: the experts held times the busiest held
expert's rows over the rows they computed, summed over the window's MoE
calls (``moe.rows_max`` and ``moe.rows_held``, the program's counters).
A product padded to the busiest expert computes this many rows for each
routed one; 1 when the load is even.  Nothing where the program has no
such counters."""


def read(ctx):
    c = ctx.counters
    if not c.get("moe.rows_held"):
        return None
    return c["moe.experts_held"] * c["moe.rows_max"] / c["moe.rows_held"]
