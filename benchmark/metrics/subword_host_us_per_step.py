"""The host's time in the subword model's own phases, the program's
`step.subword` (the gather-mean) and `step.subword_scatter` (the rows
of every G_w) spans, per training step.  Nothing where the program
records no such span (another model, or a program without them)."""

from benchmark import spans as S


def read(ctx):
    sp = S.program_spans()
    if not sp or not ctx.steps:
        return None
    ws = S.windows(sp, "step.subword", "step.subword_scatter")
    if not ws:
        return None
    return S.length(ws) / ctx.steps * 1e6
