"""torch.cuda.max_memory_allocated() over the window (after
reset_peak_memory_stats()), in units of 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9
