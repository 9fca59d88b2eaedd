"""Steals a survey: ``RunStats.steals`` of each survey's pool, meaned over
the surveys of the window."""


def read(ctx):
    surveys = ctx.counters["surveys"]
    if not surveys:
        return None
    return sum(len(s["stats"].steals) for s in surveys) / len(surveys)
