"""Corpus words consumed over the window (accounting.words_consumed: kept,
subsample-discarded and sentence tokens, as the reference counts them),
over the window's wall time on the host's clock, ending in
torch.cuda.synchronize()."""


def read(ctx):
    if ctx.words is None:
        return None
    return ctx.words / ctx.window_s
