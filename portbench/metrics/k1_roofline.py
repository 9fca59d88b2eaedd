"""K1's share of its roofline, in %: the bytes its launches had to move
(16 B a cell: u, u_prev and c2dt2 read once, u_next written once) at the
H100's 3.35 TB/s, over the union of K1's kernel intervals.  K1 is
bytes-bound (at 120 M cells 0.573 ms of bytes against 0.075 ms of flops).
Launches on concurrent streams share the card's bandwidth, so the time is
their union, not the sum of their durations."""

from portbench.devtrace import total, union


def read(ctx):
    tr, c = ctx.trace, ctx.counters
    k1 = [o for o in tr.ops if "fd3d_kernel" in o.name]
    if not k1:
        return None
    t = total(union((o.start, o.end) for o in k1))
    return len(k1) * c["counts"].k1_least_s(c["cells"]) / t * 100.0
