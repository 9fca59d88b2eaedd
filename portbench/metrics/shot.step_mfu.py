"""The whole shot step's share of the card's peak, in %: the shot steps of
the window times one step's least time at the peaks (the larger of its
flops at 67 TFLOP/s fp32 and its bytes at 3.35 TB/s: u, u_prev, c2dt2 and
the mask read, u_next written, 20 B a cell), over the window's wall time.
It bounds K1 and its epilogue together, so it stays when a later change
fuses them."""


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    if not c["shot_steps"] or tr.window_s <= 0:
        return None
    return c["shot_steps"] * c["counts"].shot_step_least_s(c["cells"]) / tr.window_s * 100.0
