"""The share of the traced window in which no operation ran on the card,
in %."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
