"""Set-up: process start to the window's start on the host's clock:
imports, the corpus and vocabulary made from the seed, the kernels built
or loaded, the warm-up call."""


def read(ctx):
    return ctx.setup_s
