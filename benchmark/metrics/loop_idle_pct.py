"""The device's idle share of the training loop: 100 * (1 - the union of
its activities inside the program's `epoch` spans over their length),
without the call's set-up (table fill, alias table, corpus upload)."""

from benchmark import spans as S


def read(ctx):
    tr, sp = ctx.trace, S.program_spans()
    if tr is None or not tr.device or not sp:
        return None
    ep = S.windows(sp, "epoch")
    if not ep or S.length(ep) <= 0:
        return None
    return 100.0 * (1.0 - S.busy_in(tr, ep) / S.length(ep))
