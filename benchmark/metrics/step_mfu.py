"""The whole step's share of the H100's peak: the least time for a step's
work (work.StepShape: the larger of its operations over 67 TFLOP/s
float32 and its bytes over 3.35 TB/s) over the traced span's wall time a
step."""

from benchmark import peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps:
        return None
    sh = ctx.shape
    bound = peaks.bound_s(sh.step_flops(), sh.step_bytes())
    return 100.0 * bound / (tr.wall_s / ctx.steps)
