"""Device time of the sorts per training step of the traced span: the
`add` route's stable sort of each scatter's ids (ops/scatter.scatter_add,
torch.sort) runs as CUB's radix-sort kernels, or the in-place
key-value sort for short lists, all with `sort` in their names.
Nothing where no such kernel ran."""

PATTERNS = [r"(?i)sort"]


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps:
        return None
    hits = tr.matching(PATTERNS)
    if not hits:
        return None
    return sum(b - a for _, a, b in hits) / ctx.steps * 1e6
