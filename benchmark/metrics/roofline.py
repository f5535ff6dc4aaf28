"""`<kernel>_roofline`: a kernel's share of its roofline, the least time
for the work its launches of a step need (benchmark/kernels/<kernel>.py:
the larger of operations over the float32 peak and bytes over the HBM
peak) over the device time of its launches in the traced span per step.
Nothing where the cell runs no such launch."""

from benchmark import peaks


def read(ctx, kernel):
    tr = ctx.trace
    if tr is None or not ctx.steps:
        return None
    hits = tr.matching(kernel.PATTERNS, kernel.EXCLUDE)
    if not hits:
        return None
    need = kernel.per_step(ctx.shape)
    if need is None:
        return None
    t = sum(b - a for _, a, b in hits) / ctx.steps
    return 100.0 * peaks.bound_s(*need) / t
