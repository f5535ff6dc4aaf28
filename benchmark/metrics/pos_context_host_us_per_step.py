"""The host's time in kernel 12's phases of fastText's CBOW with position
weights, the program's `step.pos_context` (the forward) and
`step.pos_context_grad` (the backward and the position weights' add)
spans, per training step.  Nothing where the program records no such span
(another model, or a program without them)."""

from benchmark import spans as S


def read(ctx):
    sp = S.program_spans()
    if not sp or not ctx.steps:
        return None
    ws = S.windows(sp, "step.pos_context", "step.pos_context_grad")
    if not ws:
        return None
    return S.length(ws) / ctx.steps * 1e6
