"""The host's time inside the loop's chunk calls (the program's `chunk`
spans) per training step: what issuing a step costs the host, beside
device_us_per_step's device time of a step."""

from benchmark import spans as S


def read(ctx):
    sp = S.program_spans()
    if not sp or not ctx.steps:
        return None
    ch = S.windows(sp, "chunk")
    if not ch:
        return None
    return S.length(ch) / ctx.steps * 1e6
