"""Device time of the epoch build: the union of device activity inside
the program's `epoch_build` spans, per epoch.  In the traced one-epoch
call the device is idle when the build starts (the corpus upload
synchronizes before it) and the build's scalar fetch ends inside the
span, so the span holds the build's device work and nothing else."""

from benchmark import spans as S


def read(ctx):
    tr, sp = ctx.trace, S.program_spans()
    if tr is None or not tr.device or not sp:
        return None
    eb, ep = S.windows(sp, "epoch_build"), S.windows(sp, "epoch")
    if not eb or not ep:
        return None
    return S.busy_in(tr, eb) / len(ep) * 1e3
