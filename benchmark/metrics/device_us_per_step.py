"""Device busy time (the union of its activities) of the traced span, per
training step of the span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps:
        return None
    return tr.busy_s() / ctx.steps * 1e6
