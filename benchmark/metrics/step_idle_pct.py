"""The device's idle time while the host issues a step's phases: the idle
gaps inside the program's `epoch` spans whose middle lies inside a
`step.*` span (the step's gather, positive, negative, scatter phases), as
a share of the `epoch` spans' length; issue_idle_pct's rule on the
step's own spans.  Nothing where the program records no `step.*` span."""

from benchmark import spans as S


def read(ctx):
    tr, sp = ctx.trace, S.program_spans()
    if tr is None or not tr.device or not sp:
        return None
    parts = {n for n, *_ in sp if n.startswith("step.")}
    ep, st = S.windows(sp, "epoch"), S.windows(sp, *parts)
    if not ep or not st or S.length(ep) <= 0:
        return None
    gaps = S.idle_in(tr, ep)
    mid = S.inside(st, [0.5 * (a + b) for a, b in gaps])
    idle = sum(b - a for (a, b), m in zip(gaps, mid) if m)
    return 100.0 * idle / S.length(ep)
