"""The device's idle time while the host issues steps: the idle gaps
inside the program's `epoch` spans whose middle lies inside a `chunk`
span (a chunk call of the loop), as a share of the `epoch` spans' length.
What capturing the chunk in a CUDA graph would take away."""

from benchmark import spans as S


def read(ctx):
    tr, sp = ctx.trace, S.program_spans()
    if tr is None or not tr.device or not sp:
        return None
    ep, ch = S.windows(sp, "epoch"), S.windows(sp, "chunk")
    if not ep or not ch or S.length(ep) <= 0:
        return None
    gaps = S.idle_in(tr, ep)
    mid = S.inside(ch, [0.5 * (a + b) for a, b in gaps])
    issued = sum(b - a for (a, b), m in zip(gaps, mid) if m)
    return 100.0 * issued / S.length(ep)
