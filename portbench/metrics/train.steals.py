"""Steals a training step: ``RunStats.steals`` of each window step's pool
(``HetDPTrainer.history``), meaned over the steps."""


def read(ctx):
    stats = ctx.counters["pool_stats"]
    return sum(len(s.steals) for s in stats) / len(stats) if stats else None
