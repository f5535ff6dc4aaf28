"""Kernel 12, the position-weighted context of fastText's CBOW with
position weights (word2bits_tpu_torch/csrc/pos_context.cu,
`pos_context_kernel` and `pos_context_grad_kernel`): two launches a step
on the `-model fasttext-cbow` engine.  Its bytes: the forward reads the
slab words' vectors x [B + 2W, D], the position weights d [2W, D] and the
masks [B, 2W], and writes h [B, D]; the backward reads h's gradient e
[B, D], x again, d and the masks, and writes dx [B + 2W, D] and dd
[2W, D]; all float32.  Its operations: each of the B * 2W (center,
position) terms of h, dx and dd is two multiplies and an add, and h's
divide a column.  A cell whose model is not fasttext-cbow reads
nothing."""

from benchmark import work

PATTERNS = [r"\bpos_context(_grad)?_kernel"]
EXCLUDE = []


def per_step(shape: work.StepShape):
    """(operations, bytes) the kernel's two launches of one step need, or
    None where the cell's model has no position weights."""
    if "fasttext-cbow" not in getattr(shape.model, "MODELS", ()):
        return None
    B, D, W = shape.B, shape.D, shape.W
    N, P = B + 2 * W, 2 * W
    flops = 3.0 * 3 * B * P * D + B * D
    fwd = N * D + P * D + B * P + B * D
    bwd = B * D + N * D + P * D + B * P + N * D + P * D
    return flops, 4.0 * (fwd + bwd)
