"""Kernel 1, the fused context and positive kernel
(word2bits_tpu_torch/csrc/context.cu, `context_kernel`): one launch a step
on the banded engines with -context-pallas 1.  Its bytes are
chip_smoke.py's count (work.context_bytes); its operations the context
sums over 2W offsets and the center's dot product, u-gradient seed and v
row."""

from benchmark import work

PATTERNS = [r"\bcontext_kernel<"]
EXCLUDE = []


def per_step(shape: work.StepShape):
    """(operations, bytes) the kernel's launches of one step need, or
    None where the cell does not run it."""
    if not shape.tile:
        return None
    B, D, W = shape.B, shape.D, shape.W
    flops = 2.0 * B * 2 * W * D + 6.0 * B * D
    return flops, work.context_bytes(B, D, W, shape.tile, shape.elt)
