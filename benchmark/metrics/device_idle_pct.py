"""The device's idle share of the traced span: 100 * (1 - the union of
its activities' intervals over the span's wall time)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
