"""The part of every `train.train` call that is not training: the
program's top-level `init` (or `load`), `alias` and `upload` spans (the
table fill, the alias table, the corpus upload), seconds.  Each warm-up
and window call of a run pays it."""

from benchmark import spans as S


def read(ctx):
    sp = S.program_spans()
    if not sp:
        return None
    ws = S.windows(sp, "init", "load", "alias", "upload", top=True)
    return S.length(ws) if ws else None
