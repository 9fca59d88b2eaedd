"""The whole training step's share of the card's bf16 peak, in %: a step's
model flops (6 x matmul parameters x tokens and 3 x causal attention's
forward; rematerialisation not counted; ``counts.train_step_flops``) over
the mean of the traced steps' wall time (``pb.train.step`` spans) x 989
TFLOP/s."""


def read(ctx):
    c = ctx.counters
    steps = ctx.trace.spans_named("pb.train.step")
    if not steps:
        return None
    wall = sum(s.end - s.start for s in steps) / len(steps)
    return c["step_flops"] / (wall * c["counts"].H100_BF16_FLOP_PER_S) * 100.0
