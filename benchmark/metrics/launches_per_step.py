"""Device activities (kernels, copies, sets) of the traced span per
training step: what the host loop issues."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps:
        return None
    return len(tr.device) / ctx.steps
