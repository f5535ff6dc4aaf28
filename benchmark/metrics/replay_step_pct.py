"""The share of the traced epoch's training steps that the program
replayed from a CUDA graph: 100 x its `step.replay` spans / the steps.
The rest ran eagerly, one Python launch at a time (a capture's warm-up
step, or a route that stays eager).  A program without the replay records
neither `step.replay` nor `capture` spans, and reads nothing."""

from benchmark import spans as S


def read(ctx):
    sp = S.program_spans()
    if not sp or not ctx.steps:
        return None
    if not S.windows(sp, "step.replay", "capture"):
        return None
    return 100.0 * len(S.windows(sp, "step.replay")) / ctx.steps
