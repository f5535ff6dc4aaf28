"""The banded u-sum kernel (word2bits_tpu_torch/csrc/band_usum.cu,
`band_usum_kernel`): one launch a step on the banded CBOW engines, each
slab row's sum over the centers whose window holds it.  Its operations
are the band's products, 2 * B * 2W * D; its bytes the centers' u-gradient
rows [B, D] float32 read once, the slab rows [B + 2W, D] float32 written
once, each center's band of 2W + 1 float32 mask entries and its active
flag.  A cell whose program has no such kernel reads nothing."""

from benchmark import work

PATTERNS = [r"\bband_usum_kernel<"]
EXCLUDE = []


def per_step(shape: work.StepShape):
    """(operations, bytes) the kernel's launch of one step needs, or None
    where the cell runs no banded step."""
    if not shape.tile:
        return None
    B, D, W = shape.B, shape.D, shape.W
    flops = 2.0 * B * 2 * W * D
    nbytes = B * D * 4 + (B + 2 * W) * D * 4 + B * (2 * W + 1) * 4 + B * 4
    return flops, nbytes
