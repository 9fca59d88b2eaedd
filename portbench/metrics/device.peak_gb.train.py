"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start), in GB (1e9 bytes)."""


def read(ctx):
    return ctx.window_peak_bytes / 1e9
