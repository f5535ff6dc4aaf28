"""Device time of the kernels that are not the port's own CUDA kernels
(csrc/): PyTorch's sorts, gathers, products, concatenations and
elementwise kernels, per training step of the traced span.  Copies and
sets are left out."""

PORT_KERNELS = [r"\bcontext_kernel<", r"\btile_scatter_kernel<",
                r"\bscore_kernel<", r"\bsweep_kernel<",
                r"\bquantize_kernel<"]
NOT_KERNELS = [r"^Mem(cpy|set)"]


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.steps:
        return None
    ours = {e for e in tr.matching(PORT_KERNELS + NOT_KERNELS)}
    t = sum(b - a for e in tr.device if e not in ours
            for _, a, b in [e])
    return t / ctx.steps * 1e6
